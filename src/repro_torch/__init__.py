"""PyTorch/CUDA port of the Collage reproduction (``repro``), for an NVIDIA
H100. It imports ``torch`` and numpy and nothing of JAX or of the JAX
package; the JAX package stays the reference the port is tested against.
Entry points take ``device=`` (default ``"cuda"``) and raise when no card
is present."""
