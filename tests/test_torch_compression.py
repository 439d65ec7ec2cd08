"""The port's artifact layer (``repro_torch.core.compression``) held
against the reference (``repro.core.compression``): packed words equal
exactly, both committed fixtures load, every serving-layout array equals
the reference's, integrity failures raise, and artifacts cross between
the two packages on disk."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jc
from repro_torch.core import compression as tc

# The shapes here are tiny: one torch thread per test worker keeps torch's
# thread pool off the cores the reference's JAX tests compile on.
torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
FIXTURE_NAMES = ("pr2_mlp_only", "pr3_full")
KS = (2, 3, 4, 16, 256)


def _fixture(name):
    return os.path.join(FIXTURES, name)


def _load_both(name):
    with pytest.warns(UserWarning, match="version-1"):
        pm = tc.PackedModel.load(_fixture(name))
    with pytest.warns(UserWarning, match="version-1"):
        jpm = jc.PackedModel.load(_fixture(name))
    return pm, jpm


def _flat_port(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_port(v, f"{prefix}['{k}']")
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            yield from _flat_port(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _flat_ref(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jc.PackedLayout))[0]
    return {jax.tree_util.keystr(p): v for p, v in leaves}


def assert_tree_matches_reference(port_tree, ref_tree):
    """Same paths; tensors equal the reference arrays exactly (dtype
    included); layouts equal field by field."""
    port = dict(_flat_port(port_tree))
    ref = _flat_ref(ref_tree)
    assert sorted(port) == sorted(ref)
    for path, r in ref.items():
        p = port[path]
        if isinstance(r, jc.PackedLayout):
            assert dataclass_fields(p) == dataclass_fields(r), path
            continue
        r = np.asarray(r)
        got = p.numpy()
        assert got.dtype == r.dtype, (path, got.dtype, r.dtype)
        np.testing.assert_array_equal(got, r, err_msg=path)


def dataclass_fields(layout):
    return {f: getattr(layout, f) for f in
            ("kd", "n", "k", "bits", "lanes", "shape", "dtype", "order")}


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("shape", [(37, 29), (3, 70)])
def test_pack_words_equal_reference(k, shape):
    idx = np.random.RandomState(k).randint(0, k, size=shape)
    kd, n = shape
    w2d = tc.pack_indices_2d(idx, k)
    rows = tc.pack_rows(idx, k)
    flat, lanes = tc.pack_indices(idx, k)
    np.testing.assert_array_equal(w2d, jc.pack_indices_2d(idx, k))
    np.testing.assert_array_equal(rows, jc.pack_rows(idx, k))
    jflat, jlanes = jc.pack_indices(idx, k)
    np.testing.assert_array_equal(flat, jflat)
    assert lanes == jlanes == 32 // jc.bits_per_index(k)
    # the torch unpacks invert the packers (exactly the reference unpacks)
    got = tc.unpack_indices_2d(w2d, kd, k).numpy()
    np.testing.assert_array_equal(got, idx)
    np.testing.assert_array_equal(
        got, np.asarray(jc.unpack_indices_2d(jnp.asarray(w2d), kd, k)))
    np.testing.assert_array_equal(tc.unpack_rows(rows, n, k).numpy(), idx)
    np.testing.assert_array_equal(
        tc.unpack_indices(flat, kd * n, k).numpy(), idx.ravel())


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("shape", [(37, 29), (3, 70)])
def test_torch_packer_equals_numpy_packers(k, shape):
    """``pack_lanes_torch`` (the device-side packer of ``serving_params``
    and ``chip_smoke.py``) writes the numpy packers' words, bit for bit."""
    idx = np.random.RandomState(k + 1).randint(0, k, size=shape)
    t = torch.from_numpy(idx)
    for got, want in ((tc.pack_lanes_torch(t, k, 0), tc.pack_indices_2d(
                          idx, k)),
                      (tc.pack_lanes_torch(t, k, 1), tc.pack_rows(idx, k)),
                      (tc.pack_lanes_torch(t.reshape(-1), k, 0),
                       tc.pack_indices(idx, k)[0])):
        assert got.dtype == torch.uint32
        np.testing.assert_array_equal(got.view(torch.int32).numpy().view(
            np.uint32), want)


def test_accounting_and_paths_match_reference():
    for k in KS:
        assert tc.bits_per_index(k) == jc.bits_per_index(k)
        assert tc.compression_ratio(1000, 10, k, k) == \
            jc.compression_ratio(1000, 10, k, k)
        assert tc.quantized_bytes(1001, 7, k, k) == \
            jc.quantized_bytes(1001, 7, k, k)
        for order in ("kd", "row"):
            a = tc.PackedLayout.make(37, 29, k, order=order)
            b = jc.PackedLayout.make(37, 29, k, order=order)
            assert dataclass_fields(a) == dataclass_fields(b)
            assert a.word_shape == b.word_shape and a.words == b.words
    path = "['stacks'][0]['pos1']['mlp']['w_in']"
    assert tc.path_tokens(path) == jc.path_tokens(path)
    with pytest.raises(ValueError):
        tc.path_tokens("stacks.0")
    tree = tc.unflatten_paths({("a", 0, "x"): 1, ("a", 1, "x"): 2,
                               ("b",): 3})
    assert tree == {"a": ({"x": 1}, {"x": 2}), "b": 3}
    assert tc.DEFAULT_EXCLUDE.pattern == \
        __import__("repro.core.lc", fromlist=["x"]).DEFAULT_EXCLUDE.pattern


@pytest.mark.parametrize("name", FIXTURE_NAMES)
@pytest.mark.parametrize("packed", [True, False])
def test_fixture_serving_params_equal_reference(name, packed):
    pm, jpm = _load_both(name)
    assert_tree_matches_reference(pm.serving_params(packed=packed),
                                  jpm.serving_params(packed=packed))


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_fixture_decode_coverage_summary_equal_reference(name):
    pm, jpm = _load_both(name)
    assert_tree_matches_reference(pm.decode(), jpm.decode())
    assert pm.leaf_coverage() == jpm.leaf_coverage()
    assert pm.summary() == jpm.summary()
    mlp = ("w_in", "w_gate", "w_out")
    assert_tree_matches_reference(
        pm.serving_params(quant_names=mlp, packed=True),
        jpm.serving_params(quant_names=mlp, packed=True))


def _v2_copy(tmp_path):
    with pytest.warns(UserWarning):
        pm = tc.PackedModel.load(_fixture("pr2_mlp_only"))
    return pm.save(str(tmp_path))


def test_flipped_byte_raises_artifact_error(tmp_path):
    d = _v2_copy(tmp_path)
    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    data = dict(np.load(os.path.join(d, "arrays.npz")))
    key = sorted(k for k in data if k.startswith("p"))[0]
    arr = data[key].copy()
    arr.view(np.uint8).flat[0] ^= 1
    data[key] = arr
    np.savez(os.path.join(d, "arrays.npz"), **data)
    with pytest.raises(tc.ArtifactError, match="integrity") as e:
        tc.PackedModel.load(d)
    assert key in str(e.value) and man["packed"][0]["path"] in str(e.value)


def test_missing_or_newer_artifact_raises(tmp_path):
    with pytest.raises(tc.ArtifactError, match="no PackedModel manifest"):
        tc.PackedModel.load(str(tmp_path))
    d = _v2_copy(tmp_path)
    man_path = os.path.join(d, "manifest.json")
    with open(man_path) as f:
        man = json.load(f)
    man["version"] = 3
    with open(man_path, "w") as f:
        json.dump(man, f)
    with pytest.raises(tc.ArtifactError, match="newer"):
        tc.PackedModel.load(d)


def test_artifacts_cross_between_packages(tmp_path):
    """A port-saved artifact loads in the reference (and the reverse) and
    decodes to the same weights."""
    port_dir = _v2_copy(tmp_path / "port")
    back = jc.PackedModel.load(port_dir)
    pm = tc.PackedModel.load(port_dir)
    assert_tree_matches_reference(pm.decode(), back.decode())
    with pytest.warns(UserWarning):
        jpm = jc.PackedModel.load(_fixture("pr3_full"))
    ref_dir = jpm.save(str(tmp_path / "ref"))
    pm3 = tc.PackedModel.load(ref_dir)
    assert_tree_matches_reference(pm3.serving_params(packed=True),
                                  jpm.serving_params(packed=True))
    with open(os.path.join(port_dir, "manifest.json")) as f:
        assert json.load(f)["version"] == 2


def test_pack_is_not_ported():
    """``PackedModel.pack`` is ported; the sharded C step that a plan can
    ask for (ROADMAP.md module 14) is not, and refuses by name."""
    from repro_torch.core.plan import CompressionPlan
    with pytest.raises(NotImplementedError, match="ROADMAP.md module 14"):
        CompressionPlan.parse("adaptive:4", sharded_c_step=True)


def test_packed_leaf_indices_decode_torch_types():
    with pytest.warns(UserWarning):
        pm = tc.PackedModel.load(_fixture("pr3_full"))
    leaf = next(l for l in pm.packed.values() if l.grouped)
    idx = leaf.indices()
    assert idx.dtype == torch.int64 and tuple(idx.shape) == leaf.shape
    assert leaf.decode().dtype == torch.float32
