"""Serving demo on the PyTorch/CUDA port: the generation engine on three
contrasting smoke models — granite (GQA KV cache, ragged power-of-two
prompt buckets), RWKV6 (O(1) recurrent state, exact-length batching) and
internvl2 (VLM: the patch prefix shifts every cache position) — then
speculative decoding on the continuous slot-pool engine (a depth-truncated
draft proposes, one batched target forward verifies; greedy output equals
plain greedy decode). The program of ``examples/serve_demo.py`` through
``repro_torch.launch.serve``; it runs on the card unless ``--device cpu``
is given (further arguments pass through to every run).
  PYTHONPATH=src python examples/torch_serve_demo.py [--device cpu]
"""
import sys

from repro_torch.launch.serve import main as serve_main

RUNS = [
    ("granite-3-2b (smoke config)", ["--arch", "granite-3-2b", "--smoke", "--requests", "6",
                                     "--batch", "4", "--prompt-len", "32", "--gen", "16",
                                     "--temperature", "0.8", "--top-k", "40"]),
    ("rwkv6-1.6b (smoke config)", ["--arch", "rwkv6-1.6b", "--smoke", "--requests", "6",
                                   "--batch", "4", "--prompt-len", "32", "--gen", "16"]),
    ("internvl2-1b (smoke config)", ["--arch", "internvl2-1b", "--smoke", "--requests", "6",
                                     "--batch", "4", "--prompt-len", "32", "--gen", "16"]),
    ("gpt-tiny continuous + speculative (layers:1 draft)",
     ["--arch", "gpt-tiny", "--smoke", "--requests", "6", "--prompt-len", "32", "--gen", "16",
      "--continuous", "--slots", "4", "--speculative-draft", "layers:1", "--spec-k", "4"]),
]

if __name__ == "__main__":
    for title, args in RUNS:
        print(f"=== {title} ===")
        serve_main(args + sys.argv[1:])
