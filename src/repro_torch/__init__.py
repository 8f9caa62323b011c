"""BASS (Qin et al., 2014) on PyTorch and CUDA: the counterpart of
``repro`` whose time-slot planning scan runs as a hand-written Hopper
kernel against a device-resident ledger mirror.  See README.md."""
__version__ = "0.1.0"
