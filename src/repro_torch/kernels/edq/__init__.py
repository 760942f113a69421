"""EDQ metric partials: CUDA kernel wrapper and plain version."""
