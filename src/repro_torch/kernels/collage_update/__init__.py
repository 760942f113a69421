"""Fused Collage-AdamW bucket update: CUDA kernel wrapper, plain version, engine."""
