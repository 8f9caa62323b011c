"""Hand-written Hopper kernels for the framework's hot spots, each with a
plain PyTorch version beside it.

Submodules load lazily (PEP 562): ``ts_plan`` is imported by the numpy
scheduling core on every controller start, and must not drag torch in —
``ts_plan_device`` (which imports torch at module scope) materializes only
when a device backend is first used.  The model kernels (``ops``,
``flash_attention``, ``decode_attention``, ``mamba_scan``, ``ref``) import
torch too.
"""
import importlib

__all__ = [
    "cost", "decode_attention", "flash_attention", "mamba_scan", "ops", "ref", "ts_plan",
    "ts_plan_device",
]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
