"""The two properties the Hopper designs of kernel rows 4 and 10 rest on,
held on the plain versions and the CPU wrappers (no JAX, nothing compiled).

- ``blockwise_prefill``: a token tile in which no query sees any row is an
  exact no-op of the online softmax (the mask value is finite, so
  ``m' = m``, ``c = exp(0) = 1`` and ``l``, ``acc`` gain an exact 0).  The
  kernel skips such tiles; here the plain version gives the same bits with
  them added or dropped.
- ``page_gather``: the kernel reads ``alive`` as the bool, uint8 or int32
  tensor it is given; every dtype means the same, dead slots reading the
  trash page 0.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.blockwise_prefill import blockwise_prefill
from repro_torch.kernels.page_gather import page_gather

TILE = 8


def _rows(rng, b, s, kv, d):
    return torch.from_numpy(rng.standard_normal((b, s, kv, d)).astype(
        np.float32))


def _prefill(q, k, v, q_pos, k_pos, **kw):
    return ref.blockwise_prefill_ref(q, k, v, torch.tensor(q_pos),
                                     torch.tensor(k_pos), scale=0.3,
                                     token_tile=TILE, **kw)


@pytest.mark.parametrize("softcap", [None, 5.0])
@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("extra", ["trailing-sentinel", "trailing-future",
                                   "leading-windowed"])
def test_invisible_tiles_are_exact_noops(extra, rep, softcap):
    """Adding fully invisible tiles to the view leaves every bit of the
    plain version's output as it was."""
    rng = np.random.default_rng(rep * 10 + (softcap is not None))
    b, c, kv, hd, vd = 2, 5, 2, 12, 8
    q = torch.from_numpy(rng.standard_normal((b, c, kv * rep, hd)).astype(
        np.float32))
    k, v = _rows(rng, b, 2 * TILE, kv, hd), _rows(rng, b, 2 * TILE, kv, vd)
    window = None
    if extra == "leading-windowed":
        # base rows at [TILE, 3 * TILE); the extra first tile at [0, TILE)
        # is older than every query's window
        window = 10
        k_pos = np.arange(TILE, 3 * TILE, dtype=np.int32)
        q_pos = np.arange(window + TILE - 1, window + TILE - 1 + c,
                          dtype=np.int32)
    else:
        k_pos = np.arange(2 * TILE, dtype=np.int32)
        q_pos = np.arange(9, 9 + c, dtype=np.int32)
    kw = dict(window=window, softcap=softcap)
    base = _prefill(q, k, v, q_pos, k_pos, **kw)
    assert base.abs().max() > 0

    n_extra = 2 if extra.startswith("trailing") else 1
    ek = _rows(rng, b, n_extra * TILE, kv, hd)
    ev = _rows(rng, b, n_extra * TILE, kv, vd)
    if extra == "trailing-sentinel":
        e_pos = np.full(n_extra * TILE, ref.POS_SENTINEL, dtype=np.int32)
    elif extra == "trailing-future":
        e_pos = np.arange(n_extra * TILE, dtype=np.int32) + q_pos.max() + 1
    else:
        e_pos = np.arange(TILE, dtype=np.int32)
        assert (q_pos.min() - e_pos.max()) >= window
    if extra == "leading-windowed":
        got = _prefill(q, torch.cat([ek, k], 1), torch.cat([ev, v], 1),
                       q_pos, np.concatenate([e_pos, k_pos]), **kw)
    else:
        got = _prefill(q, torch.cat([k, ek], 1), torch.cat([v, ev], 1),
                       q_pos, np.concatenate([k_pos, e_pos]), **kw)
    assert torch.equal(got, base)


def test_invisible_tiles_through_the_cpu_wrapper():
    """The wrapper's CPU route, at the engine's layout (one slot, the view
    padded with sentinel rows past the prompt), cut to the visible tiles."""
    rng = np.random.default_rng(7)
    c, h, hd = 8, 4, 16
    q = torch.from_numpy(rng.standard_normal((1, c, h, hd)).astype(
        np.float32))
    k, v = _rows(rng, 1, 4 * TILE, h, hd), _rows(rng, 1, 4 * TILE, h, hd)
    k_pos = torch.arange(4 * TILE, dtype=torch.int32)
    k_pos[3 * TILE:] = ref.POS_SENTINEL
    for start in (0, TILE):
        q_pos = torch.arange(start, start + c, dtype=torch.int32)
        n = start + c                      # rows any query sees
        kw = dict(scale=hd ** -0.5, token_tile=TILE)
        full = blockwise_prefill(q, k, v, q_pos, k_pos, **kw)
        cut = blockwise_prefill(q, k[:, :n], v[:, :n], q_pos, k_pos[:n], **kw)
        assert torch.equal(full, cut)


def test_queries_before_every_key_give_zero():
    """No query sees any row: every tile is skipped and the output is 0,
    as in the plain version."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 4, 2, 8)).astype(
        np.float32))
    k, v = _rows(rng, 1, 2 * TILE, 2, 8), _rows(rng, 1, 2 * TILE, 2, 8)
    out = _prefill(q, k, v, np.arange(4, dtype=np.int32),
                   np.arange(100, 100 + 2 * TILE, dtype=np.int32))
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("feat,dtype", [((2, 8), torch.float32),
                                        ((3,), torch.uint8)])
def test_page_gather_alive_dtypes(feat, dtype):
    """bool, uint8 and int32 ``alive`` give the same view; dead slots read
    page 0."""
    g = torch.Generator().manual_seed(5)
    b, npg, page = 8, 3, 4
    n_phys = b * npg + 1
    pool = torch.randint(0, 100, (n_phys, page) + feat, generator=g).to(dtype)
    table = 1 + torch.randperm(n_phys - 1, generator=g)[:b * npg].reshape(
        b, npg).to(torch.int32)
    dead = [2, 5]
    alive = torch.ones(b, dtype=torch.bool)
    alive[dead] = False
    views = [page_gather(pool, table, alive.to(t))
             for t in (torch.bool, torch.uint8, torch.int32)]
    for got in views:
        assert got.dtype == dtype
        assert torch.equal(got, views[0])
    trash = pool[0].repeat((npg,) + (1,) * len(feat))
    for s in range(b):
        want = trash if s in dead else pool[table[s].long()].reshape(
            (npg * page,) + feat)
        assert torch.equal(views[0][s], want)
