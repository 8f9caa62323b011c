"""What the benchmark takes from the program: its model configuration,
built from a configuration file's ``port`` entry and held to the file's
published numbers, and the device's clock and memory readings."""
from __future__ import annotations

import gc


def port_config(conf: dict, dims):
    """The program's ``ModelConfig`` of the architecture ``conf["port"]``
    names, with the file's other ``port`` settings; raises unless its
    sizes are the configuration's."""
    from repro_torch.configs import get_config

    port = dict(conf["port"])
    cfg = get_config(port.pop("arch")).with_(**port)
    want = dict(n_layers=dims.n_layers, d_model=dims.d_model, n_heads=dims.n_heads,
                n_kv_heads=dims.n_kv_heads, resolved_head_dim=dims.head_dim, d_ff=dims.d_ff,
                vocab_size=dims.vocab, tie_embeddings=dims.tied, rope_theta=dims.rope_theta,
                norm_eps=dims.norm_eps, n_vision_tokens=dims.n_prefix)
    got = {k: getattr(cfg, k) for k in want}
    if got != want:
        raise ValueError(f"the program's {cfg.name} is {got}, the configuration {want}")
    return cfg


def sync(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


def reset_peak(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.reset_peak_memory_stats()


def peak_bytes(device: str) -> int:
    if device != "cuda":
        return 0
    import torch

    return int(torch.cuda.max_memory_allocated())


def release(device: str) -> None:
    """Return what freed tensors held to the device."""
    gc.collect()
    if device == "cuda":
        import torch

        torch.cuda.empty_cache()
