"""Batched serving example (deliverable (b), the PyTorch/CUDA port's): two
in-process replicas of a small model behind the BASS router — warm
prefixes stick to their home replica, overload triggers bandwidth-checked
migration (Algorithm 1 Case 1.2), cold requests go to the least-loaded
replica (Case 2).

    PYTHONPATH=src python examples/serve_batch_torch.py                      # on the card
    PYTHONPATH=src python examples/serve_batch_torch.py --replicas 2 --slots 4 \
        --requests 10 --prompt-len 24 --max-new 12 --s-max 96 --device cpu

With no arguments it serves with :data:`ARGV` on the card (``--device
cuda``); given arguments, it passes them alone to
``repro_torch.launch.serve.main``, whose ``--device`` is ``cuda`` unless
given.
"""
import sys

from repro_torch.launch import serve

#: The reference example's arguments.
ARGV = ["--replicas", "2", "--slots", "4", "--requests", "10",
        "--prompt-len", "24", "--max-new", "12", "--s-max", "96"]


def main(argv=None) -> dict:
    """Serve → ``launch/serve.py::main``'s result."""
    argv = sys.argv[1:] if argv is None else list(argv)
    return serve.main(argv or ARGV + ["--device", "cuda"])


if __name__ == "__main__":
    main()
