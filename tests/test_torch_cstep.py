"""The port's C step (``repro_torch.core``: quant_ops, kmeans, schemes, lc,
baselines, plan, ``PackedModel.pack``) and the plain versions of its two
kernels, held against the reference on the CPU.

Inputs are made from seeds with numpy and handed to both packages.  The
holds: assignments, counts, ``iters_run``, packed words and manifests
exact; codebooks, scales and Θ allclose at 1e-5.  Torch has no threefry,
so where the reference seeds with ``jax.random`` (k-means++, ``lc_init``'s
per-leaf keys) the reference's initial states are carried into the port
(``theta0``, ``from_numpy_tree``); k-means++ itself is held inside the
port (determinism and the D² rule).
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.zoo import tiny_cfg as ref_tiny_cfg
from repro.core import CompressionPlan as RefPlan
from repro.core import PackedModel as RefPackedModel
from repro.core import baselines as rbase
from repro.core import kmeans as rk
from repro.core import lc as rlc
from repro.core import quant_ops as rq
from repro.engine import oneshot as ref_oneshot
from repro.kernels import ref as jref
from repro_torch import configs
from repro_torch.convert import from_numpy_tree
from repro_torch.core import baselines, kmeans, lc, quant_ops
from repro_torch.core.compression import PackedModel
from repro_torch.core.plan import CompressionPlan
from repro_torch.engine import oneshot
from repro_torch.kernels import dispatch
from repro_torch.kernels.fixed_quant import fixed_quant
from repro_torch.kernels.kmeans_assign import kmeans_assign
from repro_torch.models import transformer as T

# The shapes here are tiny: one torch thread per test worker keeps torch's
# thread pool off the cores the reference's JAX tests compile on.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x)


def _bits_equal(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _special_inputs(c: int) -> np.ndarray:
    """Hazard-2 inputs of Theorem A.1 held exactly: powers of two and their
    neighbouring floats, the thresholds 1.5·2^-n themselves, ±0,
    subnormals, |t| at 2^-C and 2^-(C+1)."""
    pw = np.ldexp(np.float32(1), -np.arange(0, c + 4)).astype(np.float32)
    x = np.concatenate([
        pw, np.nextafter(pw, np.float32(0)), np.nextafter(pw, np.float32(9)),
        (np.float32(1.5) * pw).astype(np.float32),
        np.float32([2.0 ** -c, 2.0 ** -(c + 1), 0.0, 1e-40, 1e-45,
                    2.0 ** -126, 3.0, 0.5, 0.49999997, 1.0])])
    return np.concatenate([x, -x]).astype(np.float32)


def _near_thresholds(c: int) -> np.ndarray:
    """The floats one ulp either side of each threshold 1.5·2^-n."""
    th = (np.float32(1.5) * np.ldexp(np.float32(1), -np.arange(0, c + 4))
          ).astype(np.float32)
    x = np.concatenate([np.nextafter(th, np.float32(0)),
                        np.nextafter(th, np.float32(9))])
    return np.concatenate([x, -x]).astype(np.float32)


def _ulps_from_threshold(t: np.ndarray) -> np.ndarray:
    """Distance of |t| from the nearest 1.5·2^-n, in ulps of that
    threshold."""
    a = np.abs(t.astype(np.float64))
    n = np.round(np.log2(1.5 / a))
    th = 1.5 * np.exp2(-n)
    return np.abs(a - th) / np.spacing(th.astype(np.float32))


def _operator_inputs(c: int) -> np.ndarray:
    rng = np.random.RandomState(c)
    rnd = np.concatenate([rng.randn(4000) * 0.2, rng.randn(2000) * 2.0,
                          rng.randn(1000) * 1e-3]).astype(np.float32)
    return np.concatenate([rnd, _special_inputs(c)])


@pytest.mark.parametrize("name", sorted(quant_ops.FIXED_OPS))
def test_fixed_ops_match_reference_bitwise(name):
    c = 7 if name.endswith("7") else 4
    x = _operator_inputs(c)
    got = quant_ops.FIXED_OPS[name](_t(x))
    want = rq.FIXED_OPS[name](jnp.asarray(x))
    _bits_equal(got, want)
    # One ulp from a threshold, torch's log2 and XLA's (log · 1/ln 2) may
    # round f to either side: a flip there moves q to the neighbouring
    # power of two and nowhere else.
    near = _near_thresholds(c)
    got = _np(quant_ops.FIXED_OPS[name](_t(near)))
    want = np.asarray(rq.FIXED_OPS[name](jnp.asarray(near)))
    flip = got != want
    assert np.all(_ulps_from_threshold(near[flip]) <= 2)
    ratio = got[flip] / want[flip]
    assert np.all((ratio == 2.0) | (ratio == 0.5) | (want[flip] == 0)
                  | (got[flip] == 0))


def test_scale_fits_and_distortion_match_reference():
    rng = np.random.RandomState(3)
    w = (rng.randn(40, 33) * 0.3).astype(np.float32)
    cb = np.float32([-1.0, -0.5, -0.25, 0.0, 0.25, 0.5, 1.0])
    cbu = np.float32([0.3, -0.7, 0.05, 1.1])
    # ternarize_scale's argmax over a flat objective moves with the
    # cumsum's rounding: held eager, which is how the reference's schemes
    # call it (under jit XLA rounds the cumsum otherwise)
    ts = rq.ternarize_scale(jnp.asarray(w))
    bs, fit, fq, dist = jax.jit(lambda w: (
        rq.binarize_scale(w), rq.fixed_scale_fit(w, jnp.asarray(cb), iters=20),
        rq.fixed_codebook_quantize(w, jnp.asarray(cbu)),
        rq.distortion(w, w * 0.9)))(jnp.asarray(w))
    for fn, (rq_, ra) in ((quant_ops.binarize_scale, bs),
                          (quant_ops.ternarize_scale, ts)):
        q, a = fn(_t(w))
        np.testing.assert_allclose(_np(a), np.asarray(ra), **TOL)
        np.testing.assert_allclose(_np(q), np.asarray(rq_), **TOL)
    q, a, assign = quant_ops.fixed_scale_fit(_t(w), _t(cb), iters=20)
    np.testing.assert_array_equal(_np(assign), np.asarray(fit[2]))
    np.testing.assert_allclose(_np(a), np.asarray(fit[1]), **TOL)
    np.testing.assert_allclose(_np(q), np.asarray(fit[0]), **TOL)
    _bits_equal(quant_ops.fixed_codebook_quantize(_t(w), _t(cbu)), fq)
    np.testing.assert_allclose(
        _np(quant_ops.distortion(_t(w), _t(w * 0.9))), np.asarray(dist),
        **TOL)


# ---------------------------------------------------------------------------
# The two kernels' plain versions against the reference's jnp oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p,k", [(3, 2), (1000, 3), (70001, 16),
                                 (4099, 256)])
def test_plain_kmeans_assign_matches_ref(p, k):
    rng = np.random.RandomState(p + k)
    w = rng.randn(p).astype(np.float32)
    cb = rng.randn(k).astype(np.float32)          # unsorted
    cb[-1] = cb[0]                                # a tie: lower index wins
    got = kmeans_assign(_t(w), _t(cb))
    want = jref.kmeans_assign_ref(jnp.asarray(w), jnp.asarray(cb))
    np.testing.assert_array_equal(_np(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(_np(got[2]), np.asarray(want[2]))
    np.testing.assert_allclose(_np(got[1]), np.asarray(want[1]), **TOL)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32 \
        and got[2].dtype == torch.float32


def test_plain_kmeans_assign_batched_is_row_by_row():
    rng = np.random.RandomState(5)
    w = rng.randn(3, 517).astype(np.float32)
    cb = rng.randn(3, 16).astype(np.float32)
    got = kmeans_assign(_t(w), _t(cb))
    for g in range(3):
        want = jref.kmeans_assign_ref(jnp.asarray(w[g]), jnp.asarray(cb[g]))
        np.testing.assert_array_equal(_np(got[0][g]), np.asarray(want[0]))
        np.testing.assert_array_equal(_np(got[2][g]), np.asarray(want[2]))
        np.testing.assert_allclose(_np(got[1][g]), np.asarray(want[1]),
                                   **TOL)


@pytest.mark.parametrize("step", [1, 7])
def test_plain_kmeans_assign_chunked_equals_whole(monkeypatch, step):
    """The plain version's argmin over chunks of points (the card holds it
    on qwen's 155.6 M-point embedding this way) equals the whole one."""
    from repro_torch.kernels import ref
    rng = np.random.RandomState(6)
    w = _t(rng.randn(3, 517).astype(np.float32))
    cb = _t(rng.randn(3, 16).astype(np.float32))
    whole = ref.kmeans_assign_ref(w, cb)
    monkeypatch.setattr(ref, "_ASSIGN_CHUNK", 3 * 16 * step)
    for a, b in zip(ref.kmeans_assign_ref(w, cb), whole):
        _bits_equal(a, b)


@pytest.mark.parametrize("mode", ["binary", "ternary", "pow2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_fixed_quant_matches_ref(mode, dtype):
    x = _operator_inputs(4)
    jx = jnp.asarray(x).astype(dtype)
    tx = _t(x).to(getattr(torch, dtype))
    for c, scale in ((4, 1.0), (7, 1.0), (4, 0.37)):
        got = fixed_quant(tx, mode, pow2_c=c, scale=scale)
        want = jref.fixed_quant_ref(jx, mode, pow2_c=c, scale=scale)
        if dtype == "bfloat16":
            got = got.view(torch.int16)
            want = np.asarray(want).view(np.int16)
        _bits_equal(got, want)
    assert fixed_quant(tx.reshape(-1, 2), mode).shape == (x.size // 2, 2)


# ---------------------------------------------------------------------------
# k-means and the schemes
# ---------------------------------------------------------------------------

def _check_fit(res, want):
    np.testing.assert_array_equal(_np(res.assignments),
                                  np.asarray(want.assignments))
    np.testing.assert_array_equal(_np(res.iters_run),
                                  np.asarray(want.iters_run))
    np.testing.assert_allclose(_np(res.codebook), np.asarray(want.codebook),
                               **TOL)
    np.testing.assert_allclose(_np(res.distortion),
                               np.asarray(want.distortion), rtol=1e-5)


@pytest.mark.parametrize("iters", [1, 4, 50])
def test_kmeans_fit_cstep_matches_reference(iters):
    rng = np.random.RandomState(iters)
    w = (rng.randn(3, 900) * 0.05).astype(np.float32)
    init = np.stack([np.sort(rng.choice(row, 8, replace=False))
                     for row in w]).astype(np.float32)
    want, one, qi, kq = jax.jit(lambda w, c: (
        rk.kmeans_fit_grouped(w, c, iters), rk.kmeans_fit(w[1], c[1], iters),
        rk.quantile_init_grouped(w, 8), rk.kmeans_quantize(w[0], c[0, ::-1])
    ))(jnp.asarray(w), jnp.asarray(init))
    _check_fit(kmeans.kmeans_fit_cstep(_t(w), _t(init), iters=iters), want)
    _check_fit(kmeans.kmeans_fit_cstep(_t(w[1]), _t(init[1]), iters=iters),
               one)
    np.testing.assert_allclose(_np(kmeans.quantile_init_grouped(_t(w), 8)),
                               np.asarray(qi), **TOL)
    np.testing.assert_array_equal(
        _np(kmeans.kmeans_quantize(_t(w[0]), _t(init[0][::-1].copy()))),
        np.asarray(kq))


def test_kmeans_plus_plus_is_seeded_and_follows_d2():
    w = torch.tensor([[0.0, 1.0, 3.0, 10.0]])
    seeds = [kmeans.kmeans_plus_plus_init(
        torch.Generator().manual_seed(s), w, 2)[0] for s in range(2000)]
    again = [kmeans.kmeans_plus_plus_init(
        torch.Generator().manual_seed(s), w, 2)[0] for s in range(20)]
    assert all(torch.equal(a, b) for a, b in zip(again, seeds))
    # P({a, b}) = 1/n (d²(a,b)/Σ_j d²(a,j) + d²(b,a)/Σ_j d²(b,j))
    x = w[0].double()
    d2 = (x[:, None] - x[None, :]) ** 2
    probs = d2 / d2.sum(dim=1, keepdim=True) / x.numel()
    pair = probs + probs.T
    counts = {}
    for s in seeds:
        key = tuple(s.tolist())
        counts[key] = counts.get(key, 0) + 1
    n = len(seeds)
    for i in range(4):
        for j in range(i + 1, 4):
            p = pair[i, j].item()
            got = counts.pop((x[i].item(), x[j].item()), 0) / n
            # 5 binomial standard deviations
            assert abs(got - p) <= 5 * (p * (1 - p) / n) ** 0.5 + 1e-12
    assert not counts        # never a centre twice
    big = torch.randn(2, 5000, generator=torch.Generator().manual_seed(0))
    cb = kmeans.kmeans_plus_plus_init(torch.Generator().manual_seed(1),
                                      big, 16)
    assert cb.shape == (2, 16) and bool((cb.diff(dim=-1) > 0).all())
    assert bool(torch.isin(cb, big).all())


SPECS = ("adaptive:4", "adaptive_zero:4", "binary", "ternary", "pow2:4",
         "binary_scale", "ternary_scale")


@pytest.mark.parametrize("spec", SPECS)
def test_scheme_init_and_c_step_match_reference(spec):
    kw = {"init_method": "quantile"} if spec.startswith("adaptive") else {}
    scheme = CompressionPlan.parse(spec, **kw).scheme
    rscheme = RefPlan.parse(spec, **kw).scheme
    rng = np.random.RandomState(len(spec))
    wg = (rng.randn(3, 24, 20) * 0.5).astype(np.float32)
    key = jax.random.PRNGKey(0)
    def ref_run(w, grouped):
        if grouped:
            rth = jax.vmap(rscheme.init)(jax.random.split(key, 3), w)
            rq_, rth2 = jax.vmap(lambda a, t: rscheme.c_step(
                a, t, first=True))(w, rth)
            return rth, rq_, rth2, jax.vmap(rscheme.assignments)(rq_, rth2)
        rth = rscheme.init(key, w)
        rq_, rth2 = rscheme.c_step(w, rth, first=True)
        return rth, rq_, rth2, rscheme.assignments(rq_, rth2)

    ref_run = jax.jit(ref_run, static_argnums=1)
    for grouped in (False, True):
        w = wg if grouped else wg[0]
        rth, rq_, rth2, rassign = ref_run(jnp.asarray(w), grouped)
        th = scheme.init(None, _t(w), grouped=grouped)
        assert set(th) == set(rth)
        for name in th:
            np.testing.assert_allclose(_np(th[name]), np.asarray(rth[name]),
                                       **TOL)
        # the c step from the reference's own initial state
        th0 = from_numpy_tree(jax.tree_util.tree_map(np.asarray, rth))
        q, th2 = scheme.c_step(_t(w), th0, first=True, grouped=grouped)
        np.testing.assert_allclose(_np(q), np.asarray(rq_), **TOL)
        for name in th2:
            if name == "kmeans_iters":
                np.testing.assert_array_equal(_np(th2[name]),
                                              np.asarray(rth2[name]))
            else:
                np.testing.assert_allclose(_np(th2[name]),
                                           np.asarray(rth2[name]), **TOL)
        assign = scheme.assignments(q, th2, grouped=grouped)
        np.testing.assert_array_equal(_np(assign), np.asarray(rassign))
        dec = scheme.decode(assign, th2, grouped=grouped)
        np.testing.assert_allclose(_np(dec), np.asarray(rq_), **TOL)
    if spec.startswith("adaptive_zero"):
        np.testing.assert_allclose(
            _np(scheme.sparsity(_t(w), th2, grouped=True)),
            np.asarray(jax.jit(jax.vmap(rscheme.sparsity))(jnp.asarray(w),
                                                           rth2)).mean(),
            **TOL)
    assert scheme.spec == rscheme.spec
    assert scheme.bits_per_weight == rscheme.bits_per_weight
    assert scheme.codebook_entries == rscheme.codebook_entries
    assert scheme.index_entries == rscheme.index_entries


# ---------------------------------------------------------------------------
# The LC state, DC and the packer on tiny_cfg
# ---------------------------------------------------------------------------

def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _kw(spec: str) -> dict:
    return {"init_method": "quantile"} if spec.startswith("adaptive") else {}


@functools.lru_cache(maxsize=None)
def _tiny(spec: str, dtype: str = "float32"):
    """The reference's tiny_cfg params, its DC state under ``spec``
    (quantile seeding for adaptive: no random numbers), and the
    reference's initial Θ (the seeds lc_init drew, replayed with its own
    key split).  The reference runs under ``jax.jit``, as its trainer runs
    it."""
    cfg = ref_tiny_cfg(tie=True)
    tparams = T.init_params(configs.tiny_cfg(tie=True),
                            torch.Generator().manual_seed(0))
    params = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()).astype(dtype), tparams)
    plan = RefPlan.parse(spec, **_kw(spec))
    qspec = plan.build_qspec(params)
    key = jax.random.PRNGKey(1)
    paths = rlc.quant_leaf_paths(qspec)
    grouped = rlc._grouped_lookup(qspec)

    def seeds(params):
        keys = dict(zip(paths, jax.random.split(jax.random.fold_in(key, 0),
                                                len(paths))))
        flat = {jax.tree_util.keystr(p): v for p, v in
                jax.tree_util.tree_flatten_with_path(params)[0]}
        return {p: (jax.vmap(plan.scheme.init)(
            jax.random.split(keys[p], flat[p].shape[0]), flat[p])
            if grouped[p] else plan.scheme.init(keys[p], flat[p]))
            for p in paths}

    state = jax.jit(lambda p: plan.init(key, p, qspec))(params)
    return cfg, params, plan, qspec, state, jax.jit(seeds)(params)


def _check_state(st, rst):
    np.testing.assert_array_equal(_np(st.lc_iter), np.asarray(rst.lc_iter))
    np.testing.assert_allclose(_np(st.mu), np.asarray(rst.mu), rtol=1e-7)
    assert list(st.theta) == list(rst.theta)
    for p, th in st.theta.items():
        for name, v in th.items():
            np.testing.assert_allclose(_np(v), np.asarray(rst.theta[p][name]),
                                       **TOL, err_msg=f"{p} {name}")
    for tree, rtree in ((st.w_c, rst.w_c), (st.lam, rst.lam)):
        got = dict(lc.tree_items(tree))
        want = {jax.tree_util.keystr(p): v for p, v in
                jax.tree_util.tree_flatten_with_path(rtree)[0]}
        assert list(got) == list(want)
        for p in got:
            np.testing.assert_allclose(_np(got[p]), np.asarray(want[p]),
                                       **TOL, err_msg=p)


@pytest.mark.parametrize("spec", ["adaptive:4", "ternary"])
def test_dc_c_step_and_finalize_match_reference(spec):
    cfg, params, rplan, rqspec, rstate, theta0 = _tiny(spec)
    plan = CompressionPlan.parse(spec, **_kw(spec))
    tparams = from_numpy_tree(_np_tree(params))
    qspec = plan.build_qspec(tparams)
    assert lc.quant_leaf_paths(qspec) == rlc.quant_leaf_paths(rqspec)
    assert lc.param_counts(tparams, qspec) == rlc.param_counts(params,
                                                               rqspec)
    # the port's own seeding, and the reference's seeds carried over
    w_dc, st = baselines.direct_compression(None, tparams, plan)
    _check_state(st, rstate)
    _, st = baselines.direct_compression(
        None, tparams, plan, theta0=from_numpy_tree(_np_tree(theta0)))
    _check_state(st, rstate)
    assert lc.codebook_entry_count(st, plan) == \
        rlc.codebook_entry_count(rstate, rplan)
    assert plan.summary(tparams, st) == pytest.approx(
        rplan.summary(params, rstate))
    # one C step with λ ≠ 0 and μ, from the reference's state carried over
    rng = np.random.RandomState(0)
    params2 = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + (rng.randn(*a.shape) * 0.01
                                               ).astype(np.float32)), params)
    ref_c_step = jax.jit(lambda p, s: rlc.c_step(p, s, rplan.scheme, rqspec,
                                                 rplan.lc))
    rst1 = ref_c_step(params2, rstate)
    rst2 = ref_c_step(params2, rst1)
    carried = from_numpy_tree(_np_tree(rstate))
    assert isinstance(carried, lc.LCState)
    tp2 = from_numpy_tree(_np_tree(params2))
    st1 = plan.c_step(tp2, carried, qspec)
    _check_state(st1, rst1)
    st2 = plan.c_step(tp2, from_numpy_tree(_np_tree(rst1)), qspec)
    _check_state(st2, rst2)
    held = plan.c_step(tp2, st2, qspec, advance_mu=False)
    assert torch.equal(held.mu, st2.mu) and int(held.lc_iter) == 3
    rpen, rgap, rgrad, rfin = jax.jit(lambda p, s: (
        rlc.penalty_value(p, s, rqspec), rlc.feasibility_gap(p, s, rqspec),
        rlc.penalty_grad(p, s, rqspec), rlc.finalize(p, s, rqspec)))(
            params2, rst2)
    np.testing.assert_allclose(_np(lc.penalty_value(tp2, st2, qspec)),
                               np.asarray(rpen), rtol=1e-5)
    np.testing.assert_allclose(_np(lc.feasibility_gap(tp2, st2, qspec)),
                               np.asarray(rgap), rtol=1e-5)
    for got, want in ((lc.penalty_grad(tp2, st2, qspec), rgrad),
                      (lc.finalize(tp2, st2, qspec), rfin)):
        want = {jax.tree_util.keystr(p): v for p, v in
                jax.tree_util.tree_flatten_with_path(want)[0]}
        got = dict(lc.tree_items(got))
        assert list(got) == list(want)
        for p in got:
            np.testing.assert_allclose(_np(got[p]), np.asarray(want[p]),
                                       **TOL)
    # iDC: a re-quantization with λ = 0, μ = 0
    q, ist = baselines.idc_round(tp2, st2, plan.scheme, qspec)
    rq_, rist = jax.jit(lambda p, s: rbase.idc_round(
        p, s, rplan.scheme, rqspec))(params2, rst2)
    _check_state(ist, rist)


@pytest.mark.parametrize("spec,dtype", [("adaptive:4", "float32"),
                                        ("pow2:2", "bfloat16")])
def test_pack_matches_reference_words_and_manifest(spec, dtype, tmp_path):
    cfg, params, rplan, rqspec, rstate, _ = _tiny(spec, dtype)
    plan = CompressionPlan.parse(spec, **_kw(spec))
    tparams = from_numpy_tree(_np_tree(params))
    pm = plan.pack(tparams, from_numpy_tree(_np_tree(rstate)))
    rpm = rplan.pack(params, rstate, rqspec)
    assert sorted(pm.packed) == sorted(rpm.packed)
    for p, leaf in pm.packed.items():
        _bits_equal(leaf.words, rpm.packed[p].words)
        _bits_equal(leaf.codebook, rpm.packed[p].codebook)
        assert (leaf.shape, leaf.k, leaf.dtype) == (
            rpm.packed[p].shape, rpm.packed[p].k, rpm.packed[p].dtype)
    with open(os.path.join(pm.save(str(tmp_path / "port")),
                           "manifest.json")) as f:
        got = json.load(f)
    with open(os.path.join(rpm.save(str(tmp_path / "ref")),
                           "manifest.json")) as f:
        want = json.load(f)
    assert got == want


def test_port_packed_artifact_serves_in_reference(tmp_path):
    """DC + pack in the port (quantile seeding: no random numbers), saved;
    the reference loads it and serves the port's greedy tokens."""
    cfg = configs.tiny_cfg(tie=True)
    _, params, *_ = _tiny("adaptive:4")
    tparams = from_numpy_tree(_np_tree(params))
    plan = CompressionPlan.parse("adaptive:4", init_method="quantile")
    qspec = plan.build_qspec(tparams)
    dispatch.reset_launch_counts()
    _, state = baselines.direct_compression(None, tparams, plan)
    pm = plan.pack(tparams, state, qspec)
    assert dispatch.launch_counts() == {n: 0 for n in dispatch.KERNELS}
    d = pm.save(str(tmp_path / "dc"))
    rpm = RefPackedModel.load(d)
    prompts = np.random.RandomState(4).randint(0, cfg.vocab, size=(2, 7))
    toks, _ = oneshot.greedy_generate(
        PackedModel.load(d).serving_params(packed=True), cfg,
        torch.from_numpy(prompts), 5)
    rtoks, _ = ref_oneshot.greedy_generate(
        rpm.serving_params(packed=True), ref_tiny_cfg(tie=True),
        jnp.asarray(prompts), 5)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(rtoks))
    assert pm.summary()["ratio"] == pytest.approx(
        plan.summary(tparams, state)["ratio"])
