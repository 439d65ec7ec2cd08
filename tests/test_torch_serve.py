"""The port's one-shot serving slice held against the reference on the CPU:
``tiny_cfg(tie=True)`` served from the ``pr2_mlp_only`` artifact at full
coverage (prefill logits, decode caches, greedy streams), the three
serving layouts bitwise inside the port, weights carried across with
``convert.from_numpy_tree``, the launcher, the configs, and the port's
import hygiene (no ``jax``, nothing of ``repro``)."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.zoo import tiny_cfg as ref_tiny_cfg
from repro.configs import get_config as ref_get_config
from repro.configs import reduce_config as ref_reduce_config
from repro.core import PackedModel as RefPackedModel
from repro.engine import Engine as RefEngine
from repro.engine import Request as RefRequest
from repro.engine import oneshot as ref_oneshot
from repro.models import transformer as RT
from repro_torch import configs
from repro_torch.convert import from_numpy_tree, tree_leaves
from repro_torch.core.compression import PackedModel
from repro_torch.engine import oneshot
from repro_torch.kernels import dispatch
from repro_torch.launch import serve
from repro_torch.models import transformer as T

# The shapes here are tiny: one torch thread per test worker keeps torch's
# thread pool off the cores the reference's JAX tests compile on.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "pr2_mlp_only")
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def pr2():
    with pytest.warns(UserWarning):
        pm = PackedModel.load(FIXTURE)
    with pytest.warns(UserWarning):
        rpm = RefPackedModel.load(FIXTURE)
    g = np.load(os.path.join(FIXTURE, "golden.npz"))
    return dict(pm=pm, rpm=rpm, cfg=configs.tiny_cfg(tie=True),
                rcfg=ref_tiny_cfg(tie=True), tokens=g["tokens"],
                golden=g["logits"], sp=pm.serving_params(packed=True),
                rsp=rpm.serving_params(packed=True))


def _np(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def test_prefill_logits_match_reference_and_golden(pr2):
    logits, _ = T.prefill(pr2["sp"], pr2["cfg"],
                          torch.from_numpy(pr2["tokens"]))
    ref_logits, _ = RT.prefill(pr2["rsp"], pr2["rcfg"],
                               jnp.asarray(pr2["tokens"]))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    np.testing.assert_allclose(logits.numpy(), pr2["golden"], **TOL)


@pytest.mark.parametrize("block", [3, 5])
def test_prefill_blocks_match_golden(pr2, block):
    """Any block partition gives the golden (full-sequence reference)
    logits at every position."""
    logits, _ = T.prefill(pr2["sp"], pr2["cfg"],
                          torch.from_numpy(pr2["tokens"]), block=block)
    np.testing.assert_allclose(logits.numpy(), pr2["golden"], **TOL)


def test_decode_logits_and_caches_match_reference(pr2):
    toks = pr2["tokens"]
    s, steps = toks.shape[1], 3
    feed = np.random.RandomState(0).randint(0, 96, size=(toks.shape[0],
                                                         steps))
    logits, caches = T.prefill(pr2["sp"], pr2["cfg"], torch.from_numpy(toks),
                               last_logits_only=True)
    caches = oneshot.grow_caches(caches, s, steps)
    rlogits, rcaches = RT.prefill(pr2["rsp"], pr2["rcfg"], jnp.asarray(toks),
                                  last_logits_only=True)
    rcaches = ref_oneshot.grow_caches(rcaches, s, steps)
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), **TOL)
    for t in range(steps):
        tok = feed[:, t:t + 1]
        logits, caches = T.decode_step(pr2["sp"], pr2["cfg"], caches,
                                       torch.from_numpy(tok), s + t)
        rlogits, rcaches = RT.decode_step(pr2["rsp"], pr2["rcfg"], rcaches,
                                          jnp.asarray(tok, jnp.int32),
                                          jnp.asarray(s + t, jnp.int32))
        np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits),
                                   **TOL)
    port = [t.numpy() for t in tree_leaves(caches)]
    ref = _np(rcaches)
    assert len(port) == len(ref) == 2
    for a, b in zip(port, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("block", [None, 3])
def test_greedy_tokens_equal_reference(pr2, block):
    toks, _ = oneshot.greedy_generate(pr2["sp"], pr2["cfg"],
                                      torch.from_numpy(pr2["tokens"]), 6,
                                      block=block)
    ref_toks, _ = ref_oneshot.greedy_generate(pr2["rsp"], pr2["rcfg"],
                                              jnp.asarray(pr2["tokens"]), 6,
                                              block=block)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(ref_toks))


def _run(params, cfg, tokens, steps=3):
    """Prefill (all positions) + greedy decode: every output and cache."""
    logits, caches = T.prefill(params, cfg, tokens)
    outs = [logits]
    caches = oneshot.grow_caches(caches, tokens.shape[1], steps)
    tok = torch.argmax(logits[:, -1], -1)[:, None]
    for t in range(steps):
        logits, caches = T.decode_step(params, cfg, caches, tok,
                                       tokens.shape[1] + t)
        outs.append(logits)
        tok = torch.argmax(logits[:, -1], -1)[:, None]
    return outs + tree_leaves(caches)


def test_serving_layouts_agree_bitwise_in_port(pr2):
    pm, cfg = pr2["pm"], pr2["cfg"]
    tokens = torch.from_numpy(pr2["tokens"])
    want = _run(pm.decode(), cfg, tokens)
    for packed in (False, True):
        got = _run(pm.serving_params(packed=packed), cfg, tokens)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert torch.equal(a, b), f"packed={packed}"


def _by_path(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_by_path(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, tuple):
        out = {}
        for i, v in enumerate(tree):
            out.update(_by_path(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree} if isinstance(tree, torch.Tensor) else {}


def test_weights_carried_by_from_numpy_tree(pr2):
    carried = from_numpy_tree(jax.tree_util.tree_map(np.asarray, pr2["rsp"]))
    layout = carried["embed_tok_layout"]
    assert type(layout).__module__ == "repro_torch.core.compression"
    assert layout == pr2["sp"]["embed_tok_layout"]
    a, b = _by_path(carried), _by_path(pr2["sp"])
    assert sorted(a) == sorted(b)
    for path, x in a.items():
        assert x.dtype == b[path].dtype and torch.equal(x, b[path]), path
    tokens = torch.from_numpy(pr2["tokens"])
    for x, y in zip(_run(carried, pr2["cfg"], tokens),
                    _run(pr2["sp"], pr2["cfg"], tokens)):
        assert torch.equal(x, y)


def test_transformer_module_serves_the_same(pr2):
    model = T.Transformer(pr2["cfg"], pr2["sp"], device="cpu")
    tokens = torch.from_numpy(pr2["tokens"])
    logits, caches = model(tokens)
    want, _ = T.prefill(pr2["sp"], pr2["cfg"], tokens)
    assert torch.equal(logits, want)
    cache = model.init_cache(2, 5)
    assert tuple(cache[0]["pos0"].k.shape) == (2, 2, 5, 2, 8)


def test_oneshot_helpers_match_reference():
    stream = np.array([5, 3, 9, 3, 1])
    for eos in (None, 3, 7):
        np.testing.assert_array_equal(
            oneshot.truncate_at_eos(stream, eos),
            ref_oneshot.truncate_at_eos(stream, eos))
    leaf = torch.ones(2, 1, 4, 1, 3)
    grown = oneshot.grow_caches({"c": leaf, "s": torch.ones(4)}, 4, 2)
    assert tuple(grown["c"].shape) == (2, 1, 6, 1, 3)
    assert torch.equal(grown["c"][:, :, 4:], torch.zeros(2, 1, 2, 1, 3))
    assert tuple(grown["s"].shape) == (4,)


def test_configs_match_reference():
    assert configs.list_archs() == ["deepseek-v2-lite-16b", "qwen1.5-0.5b"]
    with pytest.raises(KeyError):
        configs.get_config("gemma2-9b")
    pairs = [(configs.tiny_cfg(True), ref_tiny_cfg(True))]
    for arch in configs.list_archs():
        pairs += [(configs.get_config(arch), ref_get_config(arch)),
                  (configs.reduce_config(configs.get_config(arch)),
                   ref_reduce_config(ref_get_config(arch)))]
    for port, ref in pairs:
        a, b = dataclasses.asdict(port), dataclasses.asdict(ref)
        assert a == b
        assert port.n_layers == ref.n_layers


def test_unported_layer_kinds_raise():
    cfg = configs.tiny_cfg()
    gen = torch.Generator().manual_seed(0)
    for kind, item in ((T.LayerKind("gqa_local"), "module 8"),
                       (T.LayerKind("rglru", "dense"), "module 8"),
                       (T.LayerKind("ssm", "none"), "module 6")):
        bad = dataclasses.replace(cfg, stacks=(T.StackSpec((kind,), 1),))
        with pytest.raises(NotImplementedError, match=item):
            T.init_params(bad, gen)
    # the quantized KV cache (module 7) is ported: its knobs are checked
    T.check_ported(dataclasses.replace(cfg, kv_bits=4, kv_cb_mode="head"))
    with pytest.raises(ValueError, match="kv_bits"):
        T.check_ported(dataclasses.replace(cfg, kv_bits=3))


@pytest.fixture(scope="module")
def reduced_qwen_artifact(tmp_path_factory):
    """A K=4 artifact of the reduced qwen1.5-0.5b config (QKV bias, tied
    embeddings, rope theta 1e6) built and saved by the reference's
    PackedModel, with random assignments and codebooks from a seed."""
    from repro.core.compression import PackedLeaf, pack_indices
    from repro.core.lc import DEFAULT_EXCLUDE
    rcfg = ref_reduce_config(ref_get_config("qwen1.5-0.5b"))
    params = RT.init_params(jax.random.PRNGKey(0), rcfg)
    rng = np.random.RandomState(0)
    packed, dense = {}, {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        ks, leaf = jax.tree_util.keystr(path), np.asarray(leaf)
        grouped = ks.startswith("['stacks']")
        groups = leaf if grouped else leaf[None]
        if groups.ndim < 3 or DEFAULT_EXCLUDE.search(ks):
            dense[ks] = leaf
            continue
        idx = rng.randint(0, 4, size=groups.shape)
        cbs = np.sort(rng.randn(len(groups), 4) * 0.1, -1).astype(np.float32)
        words = np.stack([pack_indices(i, 4)[0] for i in idx])
        packed[ks] = PackedLeaf(words=words if grouped else words[0],
                                codebook=cbs if grouped else cbs[0],
                                shape=leaf.shape, k=4, dtype="float32")
    rpm = RefPackedModel(packed=packed, dense=dense, scheme_spec="adaptive:4",
                         k=4, codebook_entries=4 * len(packed))
    d = str(tmp_path_factory.mktemp("qwen_reduced"))
    rpm.save(d)
    return d, rpm, rcfg


def test_launcher_serves_reference_artifact_like_reference(
        reduced_qwen_artifact, capsys):
    d, rpm, rcfg = reduced_qwen_artifact
    res = serve.main(["--packed", d, "--reduced", "--no-engine",
                      "--device", "cpu", "--batch", "2", "--prompt-len", "9",
                      "--gen-len", "4"])
    out = capsys.readouterr().out
    assert "serving packed artifact" in out and "req1:" in out
    assert res["tokens"].shape == (2, 4) and res["logits"].shape == (2, 4, 512)
    ref_toks, _ = ref_oneshot.greedy_generate(
        rpm.serving_params(packed=True), rcfg, jnp.asarray(res["prompts"]), 4)
    np.testing.assert_array_equal(res["tokens"], np.asarray(ref_toks))


def test_launcher_dense_random_and_uint8_layout(reduced_qwen_artifact):
    d, _, _ = reduced_qwen_artifact
    base = ["--reduced", "--no-engine", "--device", "cpu", "--batch", "2",
            "--prompt-len", "5", "--gen-len", "2"]
    res = serve.main(base)
    assert res["tokens"].shape == (2, 2) and res["device"] == "cpu"
    packed = serve.main(base + ["--packed", d])
    uint8 = serve.main(base + ["--packed", d, "--serve-layout", "uint8"])
    np.testing.assert_array_equal(packed["tokens"], uint8["tokens"])
    assert torch.equal(packed["logits"], uint8["logits"])


@pytest.mark.parametrize("extra,item", [
    # the one-shot oracle keeps dense KV: the quantized-KV flags of the
    # engine (module 7) are refused there
    (["--no-engine", "--kv-cb", "head"], "module 7"),
    (["--no-engine", "--kv-bits", "4"], "module 7"),
    (["--no-engine", "--temperature", "0.7"], "module 9"),
    (["--no-engine", "--snapshot-dir", "x"], "module 10"),
    (["--no-engine", "--mesh", "2x2"], "module 14"),
    # the uint8 layout runs on the card since kernel row 11 was ported; this
    # case, under the id of the refusal it replaced, pins another flag whose
    # path is still unported
    pytest.param(["--no-engine", "--top-k", "5"], "module 9",
                 id="extra5-section 2, kernel row 11"),
    (["--ckpt-dir", "x"], "module 13"),
    (["--temperature", "0.7"], "module 9"),
    (["--snapshot-dir", "x"], "module 10"),
])
def test_launcher_refuses_unported_flags(extra, item, capsys):
    with pytest.raises(SystemExit):
        serve.main(["--reduced", "--device", "cpu"] + extra)
    assert f"ROADMAP.md {item}" in capsys.readouterr().err


def test_launcher_engine_mode_serves_artifact_like_reference(
        reduced_qwen_artifact, capsys):
    """The default (engine) mode serves the reference-made artifact with
    the module-5 flags; every finished stream equals the reference's
    one-shot stream over the same prompts and block partition."""
    d, rpm, rcfg = reduced_qwen_artifact
    res = serve.main(["--packed", d, "--reduced", "--device", "cpu",
                      "--requests", "5", "--slots", "2", "--prompt-len", "9",
                      "--gen-len", "4", "--vary-gen", "--seed", "3",
                      "--page-size", "4", "--pages", "5", "--token-budget",
                      "8", "--deadline", "1000", "--queue-limit", "10"])
    out = capsys.readouterr().out
    assert "engine on cpu: 5 requests through 2 slots" in out
    assert sorted(res["outputs"]) == list(range(5))
    eng, stats = res["engine"], res["stats"]
    assert eng.effective_chunk == 8 and eng.pool.n_pages == 5
    assert stats["finished"] == 5 and stats["page_utilization_max"] > 0.5
    assert eng.stats.generated_tokens == \
        eng.stats.decode_tokens + eng.stats.prefill_samples
    for key in ("prefill_ms_per_block", "decode_ms_per_step",
                "tokens_per_s"):
        assert res[key] > 0
    gens = [r.max_new_tokens for r in res["requests"]]
    assert len(set(gens)) > 1 and max(gens) <= 4
    ref_toks, _ = ref_oneshot.greedy_generate(
        rpm.serving_params(packed=True), rcfg, jnp.asarray(res["prompts"]),
        4, block=8)
    for r, n in enumerate(gens):
        np.testing.assert_array_equal(res["outputs"][r],
                                      np.asarray(ref_toks)[r, :n])


def test_launcher_engine_mode_serves_quantized_kv_like_reference(
        reduced_qwen_artifact):
    """``--kv-bits 4`` (and ``--kv-cb head``) in engine mode on the CPU:
    codebook-quantized pages, every request finished, the streams equal
    across slot counts and equal to the reference engine's at the same
    knobs."""
    d, rpm, rcfg = reduced_qwen_artifact
    base = ["--packed", d, "--reduced", "--device", "cpu", "--requests", "3",
            "--prompt-len", "9", "--gen-len", "4", "--page-size", "4",
            "--kv-bits", "4"]
    dispatch.reset_launch_counts()
    runs = [serve.main(base + extra) for extra in
            (["--slots", "2"], ["--slots", "3"],
             ["--slots", "2", "--kv-cb", "head"])]
    assert dispatch.launch_counts() == {n: 0 for n in dispatch.KERNELS}
    for res, mode in zip(runs, ("page", "page", "head")):
        eng = res["engine"]
        assert (eng.kv_bits, eng.cfg.kv_bits, eng.cfg.kv_cb_mode) == \
            (4, 4, mode)
        cache = eng.caches[0]["pos0"]
        assert cache.k_words.dtype == torch.int32
        assert cache.k_cb.shape[-2:] == \
            ((rcfg.n_kv if mode == "head" else 1), 16)
        assert sorted(res["outputs"]) == [0, 1, 2]
    for rid in range(3):
        np.testing.assert_array_equal(runs[0]["outputs"][rid],
                                      runs[1]["outputs"][rid])
    for res, mode in ((runs[0], "page"), (runs[2], "head")):
        ref_eng = RefEngine(rpm.serving_params(packed=True), rcfg, n_slots=2,
                            page_size=4, max_seq=13, kv_bits=4,
                            kv_cb_mode=mode)
        want = ref_eng.run([RefRequest(rid=r.rid, prompt=r.prompt,
                                       max_new_tokens=r.max_new_tokens)
                            for r in res["requests"]])
        for rid in range(3):
            np.testing.assert_array_equal(res["outputs"][rid],
                                          np.asarray(want[rid]))


def test_launcher_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(SystemExit, match="no CUDA device"):
        serve.main(["--reduced", "--no-engine"])


def test_launcher_refuses_corrupt_artifact(tmp_path):
    with pytest.raises(SystemExit, match="refusing to serve"):
        serve.main(["--reduced", "--no-engine", "--device", "cpu",
                    "--packed", str(tmp_path)])


def test_port_imports_neither_jax_nor_reference():
    """Every module of the port, and chip_smoke.py's imports, load without
    pulling in jax or any repro module."""
    code = r"""
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
sys.path.insert(0, sys.argv[1])
import chip_smoke
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith(("jax.", "jaxlib"))
             or n == "repro" or n.startswith("repro."))
assert not bad, bad
assert "repro_torch.launch.serve" in sys.modules
print("clean")
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code, ROOT], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")
