"""The port's kernel layer held against the reference: each kernel's plain
PyTorch version (what the wrapper runs on CPU tensors) against the
reference's jnp oracle, the routing of ``repro_torch.kernels.dispatch``
against ``repro.kernels.dispatch`` (the ``ref`` backend, as the reference
tests run on the CPU), the wrappers' argument checks, and the kernel
build's host side.  The ``cuda``-marked tests of the kernels on the card
are in ``tests/test_torch_cuda.py``.
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jc
from repro.kernels import dispatch as jdispatch
from repro.kernels import ref as jref
from repro.kernels import unpack as junpack
from repro_torch.core import compression as tc
from repro_torch.kernels import build, dispatch, ref, unpack
from repro_torch.kernels.blockwise_prefill import blockwise_prefill
from repro_torch.kernels.codebook_matmul_packed import codebook_matmul_packed
from repro_torch.kernels.codebook_matmul_packed_t import \
    codebook_matmul_packed_t
from repro_torch.kernels.quantized_gather import quantized_gather

# The shapes here are tiny: one torch thread per test worker keeps torch's
# thread pool off the cores the reference's JAX tests compile on.
torch.set_num_threads(1)

KS = (2, 4, 16, 256)
TOL = dict(rtol=1e-5, atol=1e-5)


def _operands(k, rows, cols, seed):
    rng = np.random.RandomState(seed)
    cb = np.sort(rng.randn(k)).astype(np.float32)
    idx = rng.randint(0, k, size=(rows, cols))
    return rng, cb, idx


@pytest.mark.parametrize("k", KS)
def test_quantized_gather_plain_exact_vs_reference(k):
    rng, cb, idx = _operands(k, 37, 29, k)
    words = tc.pack_rows(idx, k)
    tokens = rng.randint(0, 37, size=(11,))
    want = np.asarray(jref.quantized_gather_ref(
        jnp.asarray(tokens), jnp.asarray(words), jnp.asarray(cb), 29))
    got = quantized_gather(torch.from_numpy(tokens), tc.as_words(words),
                           torch.from_numpy(cb), 29)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), cb[idx[tokens]])


@pytest.mark.parametrize("k", KS)
def test_codebook_matmul_packed_plain_vs_reference(k):
    rng, cb, idx = _operands(k, 37, 70, k)
    x = rng.randn(5, 37).astype(np.float32)
    words = tc.pack_indices_2d(idx, k)
    want = np.asarray(jref.packed_codebook_matmul_ref(
        jnp.asarray(x), jnp.asarray(words), jnp.asarray(cb)))
    got = codebook_matmul_packed(torch.from_numpy(x), tc.as_words(words),
                                 torch.from_numpy(cb))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("order", ["row", "kd"])
def test_codebook_matmul_packed_t_plain_vs_reference(k, order):
    rng, cb, idx = _operands(k, 101, 37, k)          # W [V=101, D=37]
    x = rng.randn(3, 37).astype(np.float32)
    words = (tc.pack_rows(idx, k) if order == "row"
             else tc.pack_indices_2d(idx, k))
    want = np.asarray(jref.packed_codebook_matmul_t_ref(
        jnp.asarray(x), jnp.asarray(words), jnp.asarray(cb), 101,
        order=order))
    got = codebook_matmul_packed_t(torch.from_numpy(x), tc.as_words(words),
                                   torch.from_numpy(cb), 101, order=order)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


PREFILL_CASES = {
    "gqa-ragged": dict(b=2, c=5, h=4, kv=2, hd=8, s=13, start=8),
    "window-softcap": dict(b=1, c=7, h=6, kv=3, hd=12, s=20, start=13,
                           window=4, softcap=5.0),
    "first-block": dict(b=2, c=6, h=2, kv=2, hd=8, s=6, start=0),
}


@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
def test_blockwise_prefill_plain_vs_reference(case):
    p = dict(PREFILL_CASES[case])
    window, softcap = p.pop("window", None), p.pop("softcap", None)
    rng = np.random.RandomState(len(case))
    q = rng.randn(p["b"], p["c"], p["h"], p["hd"]).astype(np.float32)
    k = rng.randn(p["b"], p["s"], p["kv"], p["hd"]).astype(np.float32)
    v = rng.randn(p["b"], p["s"], p["kv"], p["hd"]).astype(np.float32)
    q_pos = np.arange(p["start"], p["start"] + p["c"], dtype=np.int32)
    k_pos = np.arange(p["s"], dtype=np.int32)
    kw = dict(window=window, softcap=softcap, scale=p["hd"] ** -0.5)
    # through both routers: sentinel padding to the tile, then the oracle
    want = np.asarray(jdispatch.blockwise_prefill_attention(
        *map(jnp.asarray, (q, k, v, q_pos, k_pos)), backend="ref", **kw))
    got = dispatch.blockwise_prefill_attention(
        *map(torch.from_numpy, (q, k, v, q_pos, k_pos)), **kw)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # and the oracles directly, at a tile that splits the view
    pad = (-p["s"]) % 4
    kp = np.pad(k, ((0, 0), (0, pad), (0, 0), (0, 0)))
    vp = np.pad(v, ((0, 0), (0, pad), (0, 0), (0, 0)))
    kpos = np.concatenate([k_pos, np.full(pad, ref.POS_SENTINEL, np.int32)])
    want = np.asarray(jref.blockwise_prefill_ref(
        *map(jnp.asarray, (q, kp, vp, q_pos, kpos)), token_tile=4, **kw))
    got = blockwise_prefill(*map(torch.from_numpy, (q, kp, vp, q_pos, kpos)),
                            token_tile=4, **kw)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 8])
def test_unpack_orientations_vs_reference(bits):
    rng = np.random.RandomState(bits)
    words = rng.randint(0, 2 ** 32, size=(5, 7), dtype=np.uint64).astype(
        np.uint32)
    for port_fn, ref_fn in ((unpack.unpack_words_axis0,
                             junpack.unpack_words_axis0),
                            (unpack.unpack_words_axis1,
                             junpack.unpack_words_axis1)):
        got = port_fn(tc.as_words(words), bits).numpy()
        want = np.asarray(ref_fn(jnp.asarray(words), bits))
        np.testing.assert_array_equal(got, want)
    cb = torch.arange(1 << bits, dtype=torch.float32)
    idx = unpack.unpack_words_axis0(tc.as_words(words), bits)
    np.testing.assert_array_equal(unpack.dequant_tile(idx, cb).numpy(),
                                  idx.numpy().astype(np.float32))


@pytest.mark.parametrize("order", ["row", "kd"])
def test_dispatch_gather_and_head_routes_vs_reference(order):
    k, v, d = 16, 40, 24
    rng, cb, idx = _operands(k, v, d, 7)
    words = (tc.pack_rows(idx, k) if order == "row"
             else tc.pack_indices_2d(idx, k))
    lay = tc.PackedLayout.make(v, d, k, dtype="float32", order=order)
    jlay = jc.PackedLayout.make(v, d, k, dtype="float32", order=order)
    tokens = rng.randint(0, v, size=(2, 3))
    got = dispatch.quantized_gather(torch.from_numpy(tokens),
                                    tc.as_words(words), torch.from_numpy(cb),
                                    layout=lay)
    want = jdispatch.quantized_gather(jnp.asarray(tokens), jnp.asarray(words),
                                      jnp.asarray(cb), layout=jlay,
                                      backend="ref")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = rng.randn(2, 3, d).astype(np.float32)
    got = dispatch.packed_quantized_matmul_t(
        torch.from_numpy(x), tc.as_words(words), torch.from_numpy(cb),
        layout=lay)
    want = jdispatch.packed_quantized_matmul_t(
        jnp.asarray(x), jnp.asarray(words), jnp.asarray(cb), layout=jlay,
        backend="ref")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dispatch_cpu_matmul_is_the_dense_graph():
    """On the CPU the packed route is literally ``x @ decode`` — bitwise
    the dense layout's product."""
    k, kd, n = 16, 33, 20
    rng, cb, idx = _operands(k, kd, n, 3)
    words = tc.as_words(tc.pack_indices_2d(idx, k))
    lay = tc.PackedLayout.make(kd, n, k, dtype="float32")
    x = torch.from_numpy(rng.randn(2, 4, kd).astype(np.float32))
    dense = torch.from_numpy(cb[idx])
    got = dispatch.packed_quantized_matmul(x, words, torch.from_numpy(cb),
                                           layout=lay)
    assert torch.equal(got, x @ dense)
    assert torch.equal(dispatch.decode_packed_leaf(words,
                                                   torch.from_numpy(cb), lay),
                       dense)
    got8 = dispatch.quantized_matmul(x, torch.from_numpy(idx).to(torch.uint8),
                                     torch.from_numpy(cb))
    assert torch.equal(got8, x @ dense)
    grouped = torch.stack([words, words])
    gcb = torch.stack([torch.from_numpy(cb)] * 2)
    assert torch.equal(dispatch.decode_packed_leaf(grouped, gcb, lay),
                       torch.stack([dense, dense]))


def test_wrappers_reject_mismatched_operands():
    k, kd, n = 16, 33, 20
    _, cb, idx = _operands(k, kd, n, 5)
    words = tc.as_words(tc.pack_indices_2d(idx, k))
    cbt = torch.from_numpy(cb)
    with pytest.raises(ValueError, match="pack_indices_2d"):
        codebook_matmul_packed(torch.zeros(2, kd + 9), words, cbt)
    with pytest.raises(ValueError, match="does not match"):
        dispatch.packed_codebook_matmul(
            torch.zeros(2, kd), words, cbt,
            layout=tc.PackedLayout.make(kd, n + 1, k))
    rows = tc.as_words(tc.pack_rows(idx, k))
    with pytest.raises(ValueError, match="pack_rows"):
        quantized_gather(torch.tensor([0, 1]), rows, cbt, n + 8)
    with pytest.raises(ValueError, match="flat"):
        quantized_gather(torch.zeros(2, 2, dtype=torch.long), rows, cbt, n)
    with pytest.raises(ValueError, match="pack_rows"):
        codebook_matmul_packed_t(torch.zeros(2, n), rows, cbt, kd + 1,
                                 order="row")
    with pytest.raises(ValueError, match="order"):
        codebook_matmul_packed_t(torch.zeros(2, n), rows, cbt, kd,
                                 order="col")
    q = torch.zeros(1, 2, 2, 4)
    kv = torch.zeros(1, 8, 2, 4)
    pos = torch.arange(8)
    with pytest.raises(ValueError, match="multiple"):
        blockwise_prefill(q, kv, kv, pos[:2], pos, scale=1.0, token_tile=3)
    with pytest.raises(ValueError, match="window"):
        blockwise_prefill(q, kv, kv, pos[:2], pos, scale=1.0, token_tile=4,
                          window=0)


def test_prefill_token_tile_matches_reference(monkeypatch):
    for kind, feat in (("dense", 12), ("dense", 64), ("quant", 12)):
        for page in (None, 6, 16):
            assert dispatch.prefill_token_tile(kind, feat, page) == \
                jdispatch.prefill_token_tile(kind, feat, page)
    monkeypatch.setenv("REPRO_PREFILL_BLOCK", "5")
    assert dispatch.prefill_token_tile("dense", 64) == 5 == \
        jdispatch.prefill_token_tile("dense", 64)
    assert dispatch.DEFAULT_PREFILL_TILE == jdispatch.DEFAULT_PREFILL_TILE
    assert ref.POS_SENTINEL == jref.POS_SENTINEL


def test_kernel_sources_and_bindings_agree():
    """Host side of the build: one source per kernel, each exporting the
    entry point its wrapper binds plus the error-string helper, built for
    sm_90a into a content-addressed library under build/."""
    names = sorted(f[:-3] for f in os.listdir(build.CSRC)
                   if f.endswith(".cu"))
    assert names == sorted(build.SOURCES) == sorted(dispatch.KERNELS)
    for name in build.SOURCES:
        src = (build.CSRC / f"{name}.cu").read_text()
        assert f'extern "C" int repro_{name}(' in src
        assert "REPRO_EXPORT_ERROR_STRING" in src
        assert '#include "unpack.cuh"' in src
        assert "Replaces: src/repro/kernels/" in src
        path = build.library_path(name)
        assert path.parent == build.BUILD_DIR and path.suffix == ".so"
        assert re.fullmatch(rf"{name}-[0-9a-f]{{16}}\.so", path.name)
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert build.BUILD_DIR.parts[-2:] == ("build", "repro_torch")


def test_launch_counters_only_move_on_the_card():
    dispatch.reset_launch_counts()
    _, cb, idx = _operands(16, 33, 20, 9)
    cbt = torch.from_numpy(cb)
    codebook_matmul_packed(torch.zeros(2, 33),
                           tc.as_words(tc.pack_indices_2d(idx, 16)), cbt)
    quantized_gather(torch.tensor([1, 2]), tc.as_words(tc.pack_rows(idx, 16)),
                     cbt, 20)
    assert dispatch.launch_counts() == {n: 0 for n in dispatch.KERNELS}
