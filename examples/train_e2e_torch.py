"""End-to-end training example (deliverable (b), the PyTorch/CUDA port's):
trains a small LM for a few hundred steps with the full substrate engaged
— BASS shard placement, the train step, AdamW, async checkpointing,
restart-resume, heartbeat supervision — and prints a decreasing loss.

Defaults are the reference example's (~2 M params, 300 steps on the
synthetic copy task), on the card; ``--preset 100m`` selects the ~100
M-param config; any assigned architecture runs via ``--arch <id>
--smoke``.  Checkpoints go to ``build/ckpt_e2e_torch`` unless
``--ckpt-dir`` says otherwise.

    PYTHONPATH=src python examples/train_e2e_torch.py                 # on the card
    PYTHONPATH=src python examples/train_e2e_torch.py --steps 20 --ckpt-dir /tmp/ck --device cpu

Given arguments, it passes them alone to ``repro_torch.launch.train.main``,
whose ``--device`` is ``cuda`` unless given.
"""
import sys
from pathlib import Path

from repro_torch.launch import train

#: The reference example's arguments, its checkpoints under ``build/``.
ARGV = ["--preset", "tiny", "--steps", "300", "--batch", "16",
        "--log-every", "25", "--ckpt-every", "100",
        "--ckpt-dir", str(Path(__file__).resolve().parents[1] / "build" / "ckpt_e2e_torch")]


def main(argv=None) -> dict:
    """Train → ``launch/train.py::main``'s result."""
    argv = sys.argv[1:] if argv is None else list(argv)
    return train.main(argv or ARGV + ["--device", "cuda"])


if __name__ == "__main__":
    main()
