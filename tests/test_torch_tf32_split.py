"""Why the tensor-core plan of the codebook matmuls (kernel rows 1 and 11,
``csrc/codebook_mma.cuh``) takes three TF32 passes: emulated on the CPU,
at the qwen1.5-0.5b projection shapes with a K = 16 codebook.

The kernels round with ``cvt.rna.tf32.f32``: to nearest at TF32's 10
mantissa bits, ties away from zero.  Emulated here on the int32 view (the
sign-magnitude layout makes one integer add round both signs away from
zero).  Each product x·w becomes x_hi·w_hi + x_hi·w_lo + x_lo·w_hi, every
term exact in f32, summed in f32; the test holds it within 1e-5 x max |y|
of an f64 product and prints, beside it, the error of one pass (x_hi·w_hi
alone, ~4e-4 x max |y|, four times the 1e-4 gate the kernels are held to
on the card).  No JAX, no card.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config

_CFG = get_config("qwen1.5-0.5b")
# (Kd, N) of the projections: q/k/v/o, w_in/w_gate, w_out
QWEN_PROJ = {"attn": (_CFG.d_model, _CFG.n_heads * _CFG.head_dim),
             "mlp-in": (_CFG.d_model, _CFG.d_ff),
             "mlp-out": (_CFG.d_ff, _CFG.d_model)}


def tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """f32 → TF32 (kept in f32): round to nearest at 10 mantissa bits,
    ties away from zero, as ``cvt.rna.tf32.f32`` (finite, normal v)."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(v: torch.Tensor):
    hi = tf32_rna(v)
    return hi, tf32_rna(v - hi)


def test_tf32_rna_rounds_to_ten_mantissa_bits():
    v = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12, 3.0, -0.1], dtype=torch.float32)
    got = tf32_rna(v)
    # a tie rounds away from zero; below half an ulp rounds down
    assert got[0].item() == 1.0 + 2.0 ** -10
    assert got[1].item() == 1.0 + 2.0 ** -10
    assert got[2].item() == -(1.0 + 2.0 ** -10)
    assert got[3].item() == 1.0
    assert got[4].item() == 3.0
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    hi, lo = split(v)
    assert ((hi.double() + lo.double() - v.double()).abs()
            <= 2.0 ** -21 * v.double().abs()).all()


@pytest.mark.parametrize("proj", sorted(QWEN_PROJ))
def test_three_tf32_passes_hold_1e5_where_one_pass_does_not(proj):
    kd, n = QWEN_PROJ[proj]
    rng = np.random.default_rng(kd + n)
    x = torch.from_numpy(rng.standard_normal((64, kd), dtype=np.float32))
    cb = torch.from_numpy(np.sort(rng.standard_normal(16)).astype(np.float32))
    w = cb[torch.from_numpy(rng.integers(0, 16, (kd, n)))]
    want = x.double() @ w.double()
    scale = want.abs().max().item()
    (xh, xl), (wh, wl) = split(x), split(w)
    three = (xl @ wh + xh @ wl) + xh @ wh
    one = xh @ wh
    err3 = (three.double() - want).abs().max().item() / scale
    err1 = (one.double() - want).abs().max().item() / scale
    print(f"{proj} Kd={kd} N={n}: 3xTF32 {err3:.2e}, one TF32 pass "
          f"{err1:.2e} of max |y|")
    assert err3 <= 1e-5
