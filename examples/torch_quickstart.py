"""Quickstart on the PyTorch/CUDA port: pretrain a tiny GPT with
Collage-plus (strict bf16 storage, no fp32 master weights) on the synthetic
corpus, watching loss + EDQ. The program of ``examples/quickstart.py``
through ``repro_torch.launch.train``; it runs on the card unless
``--device cpu`` is given (further arguments pass through to the trainer).
  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import sys

from repro_torch.launch.train import main as train_main

ARGS = ["--arch", "gpt-tiny", "--steps", "120", "--precision", "C", "--b2", "0.999",
        "--log-every", "20"]

if __name__ == "__main__":
    train_main(ARGS + sys.argv[1:])
