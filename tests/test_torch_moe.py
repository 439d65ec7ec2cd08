"""The port's MoE layer (``repro_torch.models.moe``) held against the
reference's local path on the CPU, at the reduced ``deepseek-v2-lite-16b``
config (4 experts, top 2, one shared expert): the routes exactly (expert
ids, kept pairs, dispatch slots, the pairs' order), the layer's output
allclose 1e-5, with and without capacity drops, at an exact router tie
(``lax.top_k`` picks the lower index), and the configs' MoE / MLA specs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduce_config as ref_reduce_config
from repro.models import moe as jmoe
from repro.models import transformer as RT
from repro_torch import configs
from repro_torch.convert import from_numpy_tree
from repro_torch.models import moe
from repro_torch.models import transformer as T

# The shapes here are tiny: one torch thread per test worker keeps torch's
# thread pool off the cores the reference's JAX tests compile on.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "deepseek-v2-lite-16b"


@pytest.fixture(scope="module")
def layer():
    """The first MoE layer's params of the reduced config, made by the
    reference from a seed, in both frameworks."""
    rcfg = ref_reduce_config(ref_get_config(ARCH))
    rp = jmoe.init_moe(jax.random.PRNGKey(3), rcfg.d_model,
                       rcfg.moe.d_ff_expert, rcfg.moe.n_experts,
                       rcfg.moe.n_shared, rcfg.mlp_act)
    tp = from_numpy_tree(jax.tree_util.tree_map(np.asarray, rp))
    return rcfg, rp, tp


def _x(b, s, d, seed):
    return np.random.RandomState(seed).randn(b, s, d).astype(np.float32)


def _ref_routes(rp, x, top_k, cf):
    """The reference's routing and per-row dispatch, as apply_moe runs
    them (jitted)."""
    def f(x):
        logits = x @ rp["router_w"]
        gates, eidx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), top_k)
        gates = gates / jnp.maximum(gates.sum(-1, keepdims=True), 1e-9)
        e = rp["router_w"].shape[1]
        c = max(1, int(x.shape[1] * top_k * cf / e))
        rows = jax.vmap(lambda xt, ei, ga: jmoe._dispatch_row(
            xt, ei, ga, e, c, top_k))(x, eidx, gates)
        return (gates, eidx) + rows
    return [np.asarray(a) for a in jax.jit(f)(jnp.asarray(x))]


@pytest.mark.parametrize("cf,b,s", [(4.0, 2, 9), (1.0, 2, 16), (1.25, 3, 7)])
def test_apply_moe_routes_exact_and_output_matches_reference(layer, cf, b,
                                                             s):
    rcfg, rp, tp = layer
    k = rcfg.moe.top_k
    x = _x(b, s, rcfg.d_model, int(cf * 10) + s)
    gates, eidx, ex_in, dst, keep, stok, sgate = _ref_routes(rp, x, k, cf)
    tg, te = moe.route(torch.from_numpy(x), tp["router_w"], k)
    np.testing.assert_array_equal(te.numpy(), eidx)
    np.testing.assert_allclose(tg.numpy(), gates, **TOL)
    e = rp["router_w"].shape[1]
    c = moe.capacity_of(s, k, cf, e)
    assert c == max(1, int(s * k * cf / e))
    for i in range(b):
        row = moe._dispatch_row(torch.from_numpy(x[i]), te[i], tg[i], e, c,
                                k)
        np.testing.assert_array_equal(row[1].numpy(), dst[i])
        np.testing.assert_array_equal(row[2].numpy(), keep[i])
        np.testing.assert_array_equal(row[3].numpy(), stok[i])
        np.testing.assert_allclose(row[0].numpy(), ex_in[i], **TOL)
    if cf == 1.0:
        assert not keep.all()            # the capacity drops are exercised
    want = jax.jit(lambda p, x: jmoe.apply_moe(
        p, x, top_k=k, act=rcfg.mlp_act, capacity_factor=cf))(rp,
                                                             jnp.asarray(x))
    got = moe.apply_moe(tp, torch.from_numpy(x), top_k=k, act=rcfg.mlp_act,
                        capacity_factor=cf)
    assert got.shape == (b, s, rcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_exact_router_tie_picks_the_lower_expert(layer):
    """Three experts with identical router columns tie exactly for every
    token: ``lax.top_k`` keeps the two lowest ids, and so must the port."""
    rcfg, rp, _ = layer
    w = np.asarray(rp["router_w"]).copy()
    w[:, 2] = w[:, 1]
    w[:, 3] = w[:, 1]
    w[:, 0] = -5.0 * np.abs(w[:, 1])
    rp = dict(rp, router_w=jnp.asarray(w))
    tp = from_numpy_tree(jax.tree_util.tree_map(np.asarray, rp))
    x = np.abs(_x(1, 5, rcfg.d_model, 11))
    gates, eidx = _ref_routes(rp, x, rcfg.moe.top_k, 4.0)[:2]
    tg, te = moe.route(torch.from_numpy(x), tp["router_w"], rcfg.moe.top_k)
    probs = moe.router_probs(torch.from_numpy(x), tp["router_w"])
    assert torch.equal(probs[..., 1], probs[..., 2])    # the tie is exact
    np.testing.assert_array_equal(te.numpy(), eidx)
    assert (te.numpy()[..., :2] == [1, 2]).all()
    np.testing.assert_array_equal(tg.numpy(), gates)
    vals, idx = moe.top_k(torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3]]), 4)
    assert idx.tolist() == [[1, 2, 4, 3]]
    want = jmoe.apply_moe(rp, jnp.asarray(x), top_k=rcfg.moe.top_k)
    got = moe.apply_moe(tp, torch.from_numpy(x), top_k=rcfg.moe.top_k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_combine_adds_in_ascending_expert_order():
    """A token's k contributions are added from 0 in ascending expert
    order on every device: the combine of a hand-made dispatch equals the
    sequential sum in that order, bit for bit."""
    e, c, d, k = 4, 3, 5, 3
    ex_out = torch.randn(e, c, d, generator=torch.Generator().manual_seed(0))
    eidx = torch.tensor([[3, 0, 2], [1, 2, 0]])
    gates = torch.tensor([[0.5, 0.3, 0.2], [0.6, 0.3, 0.1]])
    x = torch.zeros(2, d)
    _, dst, keep, stok, sgate = moe._dispatch_row(x, eidx, gates, e, c, k)
    got = moe._combine_row(ex_out, dst, keep, stok, sgate, 2, k)
    assert keep.all()
    flat = ex_out.reshape(e * c, d)
    for t in range(2):
        want = torch.zeros(d)
        for ex in sorted(eidx[t].tolist()):             # ascending experts
            j = eidx[t].tolist().index(ex)
            row = int(((stok == t) & (dst // c == ex)).nonzero()[0])
            want = want + flat[dst[row]] * gates[t, j]
        assert torch.equal(got[t], want)
    # the reference's scatter-add on the CPU, jitted: the same bits
    ref = jax.jit(jmoe._combine_row, static_argnums=5)(
        *(jnp.asarray(a.numpy()) for a in (ex_out, dst, keep, stok, sgate)),
        2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_moe_and_mla_specs_and_reduced_config_match_reference():
    port = configs.reduce_config(configs.get_config(ARCH))
    ref = ref_reduce_config(ref_get_config(ARCH))
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(T.MoESpec(8, 2)) == dataclasses.asdict(
        RT.MoESpec(8, 2))
    assert dataclasses.asdict(T.MLASpec()) == dataclasses.asdict(RT.MLASpec())
    assert T.MoESpec(8, 2).capacity_factor == 1.25
