"""The arithmetic of the port's attention kernel designs against the JAX
package, on the CPU.

K3 (flash decode) is a split-key decode on the card: per chunk of keys a
block writes float32 partials (m, l, acc), and a merge kernel combines
them.  ``ref.decode_split_ref`` computes exactly those partials and that
merge in plain torch, over the chunks ``decode_attention.split_plan`` gives
the kernel; here it is held against the reference's Pallas kernel in
interpret mode at the reference's float32 tolerance, with pos at 0, on a
chunk boundary and at S - 1, and, with chunks given by hand, with chunks
past pos that hold no live key.

K2 (flash attention) rounds the probabilities to bf16 before P.V on the
tensor cores, each 64-key tile's against the running row max;
``ref.attention_ref(..., p_dtype=torch.bfloat16, p_block=64)`` does the
same, it agrees with a tile-by-tile online softmax written out, and at one
layer of the model's shape its error against the reference's float32
result stays inside the bf16 tolerance.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as ref_decode
from repro.kernels import ref as ref_ref
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import CHUNK_GRANULE, split_plan
from repro_torch.kernels.flash_attention import KEY_TILE_BF16


def _normals(seed, shapes, round_to=None):
    """numpy normals (optionally rounded to ``round_to`` once) as float32
    (jax, torch) pairs."""
    rng = np.random.default_rng(seed)
    out = []
    for shp in shapes:
        x = jnp.asarray(rng.standard_normal(shp).astype(np.float32))
        if round_to is not None:
            x = x.astype(round_to).astype(jnp.float32)
        out.append((x, torch.from_numpy(np.array(x))))
    return out


SPLIT_CASES = [
    # (B, S, nq, nkv, hd, pos, plan): plan is an SM count, for split_plan's
    # own chunks of the live keys as the kernel is launched on such a card,
    # or (splits, chunk) given by hand.
    (2, 256, 8, 2, 64, 0, 132),          # one live key: one chunk
    (2, 256, 8, 2, 64, 63, 132),         # pos on the last key of chunk 3
    (2, 256, 8, 2, 64, 64, 132),         # pos on the first key of chunk 4
    (2, 256, 8, 2, 64, 255, 132),        # pos = S - 1: 16 chunks of 16
    (1, 512, 4, 1, 128, 300, 132),       # a ragged last chunk
    (2, 512, 6, 2, 64, 137, 8),          # chunks of 32 on a small card
    (1, 512, 4, 1, 128, 511, 1),         # chunks of 256
    (1, 1024, 8, 8, 128, 1023, 132),
    # The model's decode shape: 10 chunks of 64; pos on the last key of
    # chunk 9, then on the first key of an eleventh chunk.
    (4, 1024, 32, 8, 128, 600, 132),
    (4, 1024, 32, 8, 128, 639, 132),
    (4, 1024, 32, 8, 128, 640, 132),
    # By hand: chunks past pos that hold no live key, one chunk for all.
    (2, 256, 8, 2, 64, 0, (4, 64)),
    (2, 256, 8, 2, 64, 64, (4, 64)),
    (1, 512, 4, 1, 128, 300, (7, 74)),
    (2, 512, 6, 2, 64, 137, (16, 32)),
    (1, 512, 4, 1, 128, 511, (1, 512)),
]


@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_decode_split_ref_matches_reference_kernel(case):
    b, s, nq, nkv, hd, pos, plan = case
    if isinstance(plan, int):
        plan = split_plan(min(pos + 1, s), b * nkv, plan)
    splits, chunk = plan
    assert splits * chunk >= min(pos + 1, s)
    (jq, tq), (jk, tk), (jv, tv) = _normals(
        b + s + nq + nkv + hd + pos + splits, [(b, nq, 1, hd), (b, nkv, s, hd), (b, nkv, s, hd)])
    got = ref.decode_split_ref(tq, tk, tv, pos, splits, chunk)
    assert got.dtype == torch.float32 and got.shape == (b, nq, 1, hd)
    want = ref_decode.flash_decode_bhsd(jq, jk, jv, jnp.int32(pos), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_decode_split_ref_gives_zeros_before_the_first_position():
    """pos < 0: no chunk holds a live key, l = 0, and the guarded divide
    gives zeros, as the reference kernel does."""
    (jq, tq), (jk, tk), (jv, tv) = _normals(1, [(1, 4, 1, 64), (1, 2, 128, 64), (1, 2, 128, 64)])
    got = ref.decode_split_ref(tq, tk, tv, -1, *split_plan(0, 2, 132))
    want = ref_decode.flash_decode_bhsd(jq, jk, jv, jnp.int32(-1), interpret=True)
    assert not np.asarray(want).any()
    assert torch.equal(got, torch.zeros_like(got))


@pytest.mark.parametrize("live,rows,sms,want", [
    (601, 32, 132, (10, 64)),     # the model's decode: 320 blocks
    (640, 32, 132, (10, 64)),     # pos on a chunk boundary
    (4096, 32, 132, (10, 448)),
    (1, 32, 132, (1, 16)),        # pos 0
    (0, 32, 132, (1, 16)),        # pos < 0: one block, no key
    (1024, 1, 132, (64, 16)),
])
def test_split_plan_at_known_shapes(live, rows, sms, want):
    assert split_plan(live, rows, sms) == want


def test_split_plan_covers_the_live_keys_and_fills_the_card():
    for live in (1, 2, 15, 16, 17, 63, 64, 65, 600, 601, 1023, 4096, 32768):
        for rows in (1, 2, 8, 32, 128, 1024):
            splits, chunk = split_plan(live, rows, 132)
            assert chunk % CHUNK_GRANULE == 0 and chunk >= CHUNK_GRANULE
            assert (splits - 1) * chunk < live <= splits * chunk
            if live >= CHUNK_GRANULE * -(-2 * 132 // rows):
                assert splits * rows >= 2 * 132


def _online_tiles(q, k, v, causal, tile):
    """K2's loop over key tiles written out in plain torch: the running row
    max, the accumulator rescaled by e^(m_old - m_new), P rounded to bf16
    before P.V, the sum of P unrounded, one divide at the end; in float64,
    as the oracle rounds P from float64 values."""
    b, nq, sq, hd = q.shape
    nkv, sk = k.shape[1], k.shape[2]
    qg = q.reshape(b, nkv, nq // nkv, sq, hd).double()
    s = torch.einsum("bkgqh,bksh->bkgqs", qg, k.double()) / (hd ** 0.5)
    if causal:
        keep = torch.arange(sk)[None, :] <= torch.arange(sq)[:, None]
        s = torch.where(keep, s, ref.NEG_INF)
    m = torch.full(s.shape[:-1] + (1,), ref.NEG_INF, dtype=torch.float64)
    l = torch.zeros(s.shape[:-1] + (1,), dtype=torch.float64)
    acc = torch.zeros(s.shape[:-1] + (hd,), dtype=torch.float64)
    for lo in range(0, sk, tile):
        st = s[..., lo:lo + tile]
        m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        acc = acc * alpha + torch.einsum(
            "bkgqs,bksh->bkgqh", p.to(torch.bfloat16).double(), v[:, :, lo:lo + tile].double())
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        m = m_new
    return (acc / l).reshape(b, nq, sq, hd).float()


@pytest.mark.parametrize("case", [
    # (B, S, nq, nkv, hd, causal): one tile, a ragged last tile, the model's
    # heads at a shorter prompt, non-causal
    (1, 40, 4, 2, 64, True),
    (2, 96, 4, 2, 128, True),
    (1, 256, 32, 8, 128, True),
    (1, 160, 8, 2, 64, False),
], ids=str)
def test_running_max_rounding_matches_the_tile_loop(case):
    """``attention_ref(..., p_block=64)``, vectorised, against K2's loop over
    64-key tiles written out: the same bf16 roundings of P, so they differ
    only by the order of the sums."""
    b, s, nq, nkv, hd, causal = case
    (_, tq), (_, tk), (_, tv) = _normals(
        s + nq, [(b, nq, s, hd), (b, nkv, s, hd), (b, nkv, s, hd)], round_to=jnp.bfloat16)
    got = ref.attention_ref(tq, tk, tv, causal=causal, p_dtype=torch.bfloat16,
                            p_block=KEY_TILE_BF16)
    want = _online_tiles(tq, tk, tv, causal, KEY_TILE_BF16)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    # One block for the whole row is the row max's rounding, bit for bit.
    whole = ref.attention_ref(tq, tk, tv, causal=causal, p_dtype=torch.bfloat16, p_block=s)
    assert torch.equal(whole, ref.attention_ref(tq, tk, tv, causal=causal, p_dtype=torch.bfloat16))


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_probabilities_stay_within_the_bf16_tolerance(causal, capsys):
    """One layer of mistral-nemo-12b's prefill (S 512, nq 32, nkv 8, hd 128)
    on bf16-rounded inputs: P rounded to bf16 before P.V against the running
    max of 64-key tiles, as K2 does, against the reference's float32 oracle;
    within the bf16 tolerance 2e-2."""
    b, s, nq, nkv, hd = 1, 512, 32, 8, 128
    (jq, tq), (jk, tk), (jv, tv) = _normals(
        7 + causal, [(b, nq, s, hd), (b, nkv, s, hd), (b, nkv, s, hd)], round_to=jnp.bfloat16)
    got = ref.attention_ref(tq, tk, tv, causal=causal, p_dtype=torch.bfloat16,
                            p_block=KEY_TILE_BF16)
    want = np.asarray(ref_ref.attention_ref(jq, jk, jv, causal=causal))
    err = float(np.abs(got.numpy() - want).max())
    with capsys.disabled():
        print(f"\nbf16 P, causal={causal}: largest error against float32 {err}")
    assert err <= 2e-2
    exact = ref.attention_ref(tq, tk, tv, causal=causal)
    assert float((got - exact).abs().max()) > 0  # the rounding is really applied
