"""Page writes leave what a serial write leaves: the last row, in row order,
that targets a cell wins, dead slots colliding on the trash page 0
included.  ``attention._last_writer`` names, for every row, the last row
of its cell, and each write stores that row's value, so duplicates carry
equal values and the card's unordered scatter cannot change the pool;
here, on the CPU, each write path is held against a Python loop that
writes row by row.  No JAX, no card.
"""
import numpy as np
import pytest
import torch

from repro_torch.models import attention as attn


def _serial(pool, phys, off, new):
    """pool[phys[i], off[i]] = new[i] for i in row order, one at a time."""
    pool = pool.clone()
    rows = new.reshape((-1,) + new.shape[phys.ndim:])
    for i, (p, o) in enumerate(zip(phys.reshape(-1).tolist(),
                                   off.reshape(-1).tolist())):
        pool[p, o] = rows[i]
    return pool


@pytest.mark.parametrize("n_cells,rows", [(5, 40), (64, 17), (3, 3)])
def test_last_writer_against_a_serial_loop(n_cells, rows):
    rng = np.random.default_rng(n_cells * rows)
    cell = torch.from_numpy(rng.integers(0, n_cells, (rows,)))
    values = torch.from_numpy(rng.standard_normal((rows, 2, 3)))
    src = attn._last_writer(cell, n_cells)
    got = attn._take_rows(values, src)
    for i in range(rows):
        last = max(j for j in range(rows) if cell[j] == cell[i])
        assert src[i] == last
        assert torch.equal(got[i], values[last])
    # a 2-D index: rows in row-major order
    src2 = attn._last_writer(cell.reshape(-1, 1), n_cells)
    got2 = attn._take_rows(values.reshape(rows, 1, 2, 3), src2)
    assert torch.equal(got2.reshape(got.shape), got)


def _table(rng, b, npg, n_pages):
    perm = rng.permutation(n_pages)[:b * npg] + 1
    return torch.from_numpy(perm.reshape(b, npg)).to(torch.int32)


@pytest.mark.parametrize("alive", [[1, 0, 0, 1, 0, 0], [0] * 6, [1] * 6])
def test_block_write_matches_serial_with_dead_slots_on_page_0(alive):
    rng = np.random.default_rng(sum(alive) + 1)
    b, c, page, npg, start = 6, 21, 4, 7, 3
    table = _table(rng, b, npg, b * npg + 2)
    pool = torch.from_numpy(rng.standard_normal((b * npg + 3, page, 2, 5)))
    new = torch.from_numpy(rng.standard_normal((b, c, 2, 5)))
    live = torch.tensor(alive, dtype=torch.bool)
    t = start + torch.arange(c)
    phys = torch.where(live[:, None],
                       table.long()[:, torch.clamp(t // page, 0, npg - 1)], 0)
    want = _serial(pool, phys, (t % page).expand(b, c), new)
    got = attn._write_block_slot(pool.clone(), table, start, live, new, page)
    assert torch.equal(got, want)


@pytest.mark.parametrize("pos", [[0, 5, 9, 13, 1, 5, 5, 2],
                                 [3, 3, 3, 3, 3, 3, 3, 3]])
def test_slot_write_matches_serial_with_dead_slots_on_page_0(pos):
    rng = np.random.default_rng(sum(pos))
    b, page, npg = 8, 4, 4
    table = _table(rng, b, npg, b * npg)
    pool = torch.from_numpy(rng.standard_normal((b * npg + 1, page, 3)))
    new = torch.from_numpy(rng.standard_normal((b, 3)))
    live = torch.tensor([1, 0, 1, 0, 0, 1, 0, 0], dtype=torch.bool)
    posv = torch.tensor(pos)
    phys = torch.where(live, table.long()[torch.arange(b),
                                          torch.clamp(posv // page, 0,
                                                      npg - 1)], 0)
    want = _serial(pool, phys, posv % page, new)
    got = attn._write_slot(pool.clone(), table, posv, live, new, page)
    assert torch.equal(got, want)
