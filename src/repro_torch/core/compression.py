"""Compression accounting (paper eq. 14), index bit-packing, and the
:class:`PackedModel` artifact — port of ``repro.core.compression``.

ratio ρ(K) = #bits(reference) / #bits(quantized)
  #bits(reference) = (P1 + P0)·b
  #bits(quantized) = P1·⌈log2 K⌉ + (P0 + E)·b

Bit-packing stores ⌈log2 K⌉-bit assignment indices little-endian in
uint32 words, ``32 // bits`` lanes per word, no index straddling two
words.  The host packers are numpy (as in the reference);
:func:`pack_lanes_torch` packs the same layouts on any device, and the
unpacks are torch and run on any device.  PyTorch has no ``>>`` for
``torch.uint32`` on the CPU, so every torch-side unpack views the words
as int32, widens to int64, then shifts and masks (a lane never reaches
past bit 31, so the sign of the widened word never leaks into a lane).

The on-disk format (``manifest.json`` + ``arrays.npz``, manifest v1/v2)
is shared with the reference byte for byte: an artifact saved here loads
in ``repro.core.PackedModel.load`` and vice versa.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import re
import warnings
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

PyTree = Any

# Param-name patterns never quantized (copy of ``repro.core.lc``'s
# DEFAULT_EXCLUDE: dynamics/precision-sensitive or tiny leaves).
DEFAULT_EXCLUDE = re.compile(
    r"(bias|scale|norm|router|gate_logit|a_log|a_param|dt_|conv1d|embed_pos"
    r"|d_skip)",
    re.IGNORECASE,
)


class ArtifactError(RuntimeError):
    """A :class:`PackedModel` artifact is missing, truncated, or fails
    integrity verification; the message names the offending leaf/key."""


def _array_sha256(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def bits_per_index(k: int) -> int:
    return max(1, math.ceil(math.log2(k)))


def compression_ratio(p1: int, p0: int, k: int, codebook_entries: int,
                      b: int = 32) -> float:
    """Paper eq. (14).  ``codebook_entries``: floats stored with the model."""
    ref_bits = (p1 + p0) * b
    quant_bits = p1 * bits_per_index(k) + (p0 + codebook_entries) * b
    return ref_bits / quant_bits


def quantized_bytes(p1: int, p0: int, k: int, codebook_entries: int,
                    b: int = 32) -> int:
    """Absolute storage in bytes of the packed model."""
    return (p1 * bits_per_index(k) + (p0 + codebook_entries) * b + 7) // 8


# ---------------------------------------------------------------------------
# Host packers (numpy) and device unpacks (torch)
# ---------------------------------------------------------------------------

def pack_indices(assign: np.ndarray, k: int) -> Tuple[np.ndarray, int]:
    """Pack integer assignments (< k) into a flat uint32 word stream.
    Returns (words, lanes_per_word)."""
    bits = bits_per_index(k)
    lanes = 32 // bits
    flat = np.asarray(assign, dtype=np.uint32).ravel()
    flat = np.pad(flat, (0, (-flat.size) % lanes)).reshape(-1, lanes)
    words = np.zeros(flat.shape[0], dtype=np.uint32)
    for lane in range(lanes):
        words |= flat[:, lane] << np.uint32(lane * bits)
    return words, lanes


def pack_indices_2d(idx: np.ndarray, k: int) -> np.ndarray:
    """``idx`` [Kd, N] → uint32 words [⌈Kd/lanes⌉, N]: word (w, n) holds
    idx[w·lanes+l, n] at bit offset l·bits (the matmul operand layout)."""
    bits = bits_per_index(k)
    lanes = 32 // bits
    idx = np.asarray(idx, dtype=np.uint32)
    kd, n = idx.shape
    idx = np.pad(idx, ((0, (-kd) % lanes), (0, 0))).reshape(-1, lanes, n)
    words = np.zeros((idx.shape[0], n), dtype=np.uint32)
    for lane in range(lanes):
        words |= idx[:, lane, :] << np.uint32(lane * bits)
    return words


def pack_rows(idx: np.ndarray, k: int) -> np.ndarray:
    """``idx`` [V, D] → uint32 words [V, ⌈D/lanes⌉]: word (v, w) holds
    idx[v, w·lanes+l] at bit offset l·bits (the gather / tied-head
    layout: each vocab row is one contiguous packed run)."""
    bits = bits_per_index(k)
    lanes = 32 // bits
    idx = np.asarray(idx, dtype=np.uint32)
    v, d = idx.shape
    idx = np.pad(idx, ((0, 0), (0, (-d) % lanes))).reshape(v, -1, lanes)
    words = np.zeros(idx.shape[:2], dtype=np.uint32)
    for lane in range(lanes):
        words |= idx[:, :, lane] << np.uint32(lane * bits)
    return words


def pack_lanes_torch(idx: torch.Tensor, k: int, axis: int) -> torch.Tensor:
    """Pack integer indices (< k) along ``axis`` into uint32 words, on
    ``idx``'s device: axis 0 of a flat [n] tensor is :func:`pack_indices`'s
    stream, axis 0 of [Kd, N] :func:`pack_indices_2d`, the last axis of
    [V, D] :func:`pack_rows` — the same bits.  The lanes are OR-ed in int64
    and the word is kept as its int32 bit pattern, viewed as uint32."""
    bits = bits_per_index(k)
    lanes = 32 // bits
    w = idx.movedim(axis, -1).to(torch.int64)
    pad = (-w.shape[-1]) % lanes
    if pad:
        w = torch.nn.functional.pad(w, (0, pad))
    w = w.reshape(w.shape[:-1] + (-1, lanes))
    word = w[..., 0]
    for lane in range(1, lanes):
        word = word | (w[..., lane] << (lane * bits))
    word = torch.where(word >= 1 << 31, word - (1 << 32), word)
    return word.to(torch.int32).movedim(-1, axis).contiguous().view(
        torch.uint32)


def as_words(words: Union[np.ndarray, torch.Tensor],
             device: Optional[Union[str, torch.device]] = None
             ) -> torch.Tensor:
    """uint32 words (numpy or torch) → a torch.uint32 tensor."""
    if isinstance(words, np.ndarray):
        words = torch.from_numpy(np.ascontiguousarray(words, np.uint32))
    if words.dtype != torch.uint32:
        raise TypeError(f"packed words must be uint32, got {words.dtype}")
    return words if device is None else words.to(device)


def _words32(words) -> torch.Tensor:
    """Packed words as a 32-bit tensor (uint32, or its int32 view: torch
    has no uint32 indexing on CUDA, so gathers run on the int32 view)."""
    if isinstance(words, np.ndarray):
        return as_words(words)
    if words.dtype not in (torch.uint32, torch.int32):
        raise TypeError(f"packed words must be 32-bit, got {words.dtype}")
    return words


def _lanes_of(words, k: int, axis: int) -> torch.Tensor:
    """Expand 32-bit words into their ``32 // bits`` lanes on a new axis
    right after ``axis`` (int64 result)."""
    bits = bits_per_index(k)
    lanes = 32 // bits
    wide = _words32(words).view(torch.int32).to(torch.int64)
    shifts = torch.arange(lanes, device=wide.device, dtype=torch.int64) * bits
    shape = [1] * (wide.ndim + 1)
    shape[axis + 1] = lanes
    return (wide.unsqueeze(axis + 1) >> shifts.view(shape)) & ((1 << bits) - 1)


def unpack_indices(words, n: int, k: int) -> torch.Tensor:
    """Inverse of :func:`pack_indices` → int64 [n]."""
    return _lanes_of(words, k, 0).reshape(-1)[:n]


def unpack_indices_2d(words, kd: int, k: int) -> torch.Tensor:
    """Inverse of :func:`pack_indices_2d` → int64 [kd, N]."""
    words = _words32(words)
    return _lanes_of(words, k, 0).reshape(-1, words.shape[-1])[:kd]


def unpack_rows(words, d: int, k: int) -> torch.Tensor:
    """Inverse of :func:`pack_rows` over the trailing axis (any leading
    dims) → int64 [..., d]."""
    words = _words32(words)
    out = _lanes_of(words, k, words.ndim - 1)
    return out.reshape(words.shape[:-1] + (-1,))[..., :d]


@dataclasses.dataclass(frozen=True)
class PackedLayout:
    """Static lane metadata of one packed-index matmul operand (same
    fields as the reference's)."""

    kd: int        # true reduction dim (rows of the unpacked idx)
    n: int         # output dim (columns)
    k: int         # index-space size (codebook entries)
    bits: int      # bits per index = bits_per_index(k)
    lanes: int     # indices per uint32 word = 32 // bits
    # dense per-group shape when it is not the (kd, n) matrix
    shape: Optional[Tuple[int, ...]] = None
    dtype: Optional[str] = None    # original leaf dtype
    # "kd": pack_indices_2d words [⌈kd/lanes⌉, n]; "row": pack_rows
    # words [kd, ⌈n/lanes⌉]
    order: str = "kd"

    @classmethod
    def make(cls, kd: int, n: int, k: int,
             shape: Optional[Tuple[int, ...]] = None,
             dtype: Optional[str] = None,
             order: str = "kd") -> "PackedLayout":
        if order not in ("kd", "row"):
            raise ValueError(f"order={order!r}; choose kd|row")
        bits = bits_per_index(k)
        return cls(kd=kd, n=n, k=k, bits=bits, lanes=32 // bits,
                   shape=None if shape is None else tuple(shape),
                   dtype=dtype, order=order)

    @property
    def words(self) -> int:
        return -(-self.kd // self.lanes) if self.order == "kd" else self.kd

    @property
    def word_shape(self) -> Tuple[int, int]:
        if self.order == "kd":
            return (-(-self.kd // self.lanes), self.n)
        return (self.kd, -(-self.n // self.lanes))


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array; bf16 becomes ``ml_dtypes``'
    bfloat16 (numpy has no bf16 of its own), as the reference stores it."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def torch_dtype(name: str) -> torch.dtype:
    """Reference dtype string ("float32", "bfloat16", ...) → torch dtype."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# ---------------------------------------------------------------------------
# Path-keyed tree (de)construction
# ---------------------------------------------------------------------------

PathToken = Union[str, int]
_PATH_RE = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def path_tokens(path: str) -> Tuple[PathToken, ...]:
    """``"['stacks'][0]['mlp']['w_in']"`` →
    ``("stacks", 0, "mlp", "w_in")``."""
    tokens: List[PathToken] = []
    pos = 0
    for m in _PATH_RE.finditer(path):
        if m.start() != pos:
            raise ValueError(f"unparseable tree path {path!r}")
        pos = m.end()
        tokens.append(m.group(1) if m.group(1) is not None
                      else int(m.group(2)))
    if pos != len(path) or not tokens:
        raise ValueError(f"unparseable tree path {path!r}")
    return tuple(tokens)


def unflatten_paths(entries: Dict[Tuple[PathToken, ...], Any]) -> PyTree:
    """Rebuild a nested dict/tuple tree from token-path-keyed leaves.
    Integer-keyed levels become tuples (the params convention)."""
    root: dict = {}
    for tokens, val in entries.items():
        node = root
        for t in tokens[:-1]:
            node = node.setdefault(t, {})
        node[tokens[-1]] = val

    def finish(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            if sorted(node) != list(range(len(node))):
                raise ValueError(
                    f"non-contiguous sequence keys {sorted(node)}")
            return tuple(finish(node[i]) for i in range(len(node)))
        return {k: finish(v) for k, v in node.items()}

    return finish(root)


# ---------------------------------------------------------------------------
# PackedModel — the deployable artifact
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PackedLeaf:
    """One quantized leaf: bit-packed assignment words + decode codebook.
    Grouped (stacked-layer) leaves carry a leading G axis on both
    ``words`` [G, W] and ``codebook`` [G, K]."""

    words: np.ndarray        # uint32, [W] or [G, W]
    codebook: np.ndarray     # float32, [K] or [G, K]
    shape: Tuple[int, ...]   # original leaf shape
    k: int                   # index-space size
    dtype: str               # original leaf dtype

    @property
    def grouped(self) -> bool:
        return self.words.ndim == 2

    @property
    def bits(self) -> int:
        return bits_per_index(self.k)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    def indices(self, device=None) -> torch.Tensor:
        """Unpacked int64 assignment indices in the original leaf shape,
        unpacked on ``device``."""
        words = as_words(self.words, device)
        if self.grouped:
            n = int(np.prod(self.shape[1:]))
            idx = torch.stack([unpack_indices(w, n, self.k) for w in words])
        else:
            idx = unpack_indices(words, self.size, self.k)
        return idx.reshape(self.shape)

    def decode(self, device=None) -> torch.Tensor:
        """Δ(Θ): codebook gather in the leaf's original dtype, on
        ``device``."""
        idx = self.indices(device)
        cb = torch.from_numpy(np.asarray(self.codebook)).to(idx.device)
        if self.grouped:
            flat = idx.reshape(idx.shape[0], -1)
            dec = torch.gather(cb, 1, flat)
        else:
            dec = cb[idx.reshape(-1)]
        return dec.reshape(self.shape).to(torch_dtype(self.dtype))


@dataclasses.dataclass
class PackedModel:
    """Deployable quantized-model artifact (pack → save/load → serve).

    ``packed``: keystr path → PackedLeaf for every quantized leaf;
    ``dense``: keystr path → raw array for everything else.
    """

    packed: Dict[str, PackedLeaf]
    dense: Dict[str, np.ndarray]
    scheme_spec: str
    k: int
    codebook_entries: int
    bits_ref: int = 32

    GATHER_NAMES: Tuple[str, ...] = ("embed_tok",)

    @classmethod
    def pack(cls, params: PyTree, state, plan, qspec: Optional[PyTree] = None,
             bits_ref: int = 32) -> "PackedModel":
        """Pack a finished LC run: ``state`` is the LCState whose Θ defines
        the codebooks; ``plan`` a CompressionPlan (or bare Scheme).  The
        assignments and the words are computed on the tensors' device
        (``pack_lanes_torch``: the bits of the reference's
        ``pack_indices``); the artifact's arrays are numpy."""
        from repro_torch.core import lc as lc_mod
        from repro_torch.core.schemes import as_scheme

        scheme = as_scheme(plan)
        if qspec is None:
            qspec = (plan.build_qspec(params) if hasattr(plan, "build_qspec")
                     else lc_mod.default_qspec(params))
        w_c = lc_mod.finalize(params, state, qspec)
        grouped = lc_mod._grouped_lookup(qspec)
        quant_paths = set(lc_mod.quant_leaf_paths(qspec))
        k = scheme.index_entries

        packed: Dict[str, PackedLeaf] = {}
        dense: Dict[str, np.ndarray] = {}
        for ks, leaf in lc_mod.tree_items(w_c):
            if ks not in quant_paths:
                dense[ks] = _numpy(leaf)
                continue
            th = state.theta[ks]
            g = grouped[ks]
            assign = scheme.assignments(leaf, th, grouped=g)
            entries = torch.arange(k, device=leaf.device)
            if g:
                assign = assign.reshape(leaf.shape[0], -1)
                entries = entries.expand(leaf.shape[0], k)
                words = pack_lanes_torch(assign, k, 1)
            else:
                words = pack_lanes_torch(assign.reshape(-1), k, 0)
            cb = scheme.decode(entries, th, grouped=g)
            packed[ks] = PackedLeaf(
                words=words.view(torch.int32).cpu().numpy().view(np.uint32),
                codebook=cb.float().cpu().numpy(),
                shape=tuple(leaf.shape), k=k,
                dtype=str(leaf.dtype).replace("torch.", ""))
        return cls(packed=packed, dense=dense, scheme_spec=scheme.spec, k=k,
                   codebook_entries=lc_mod.codebook_entry_count(state,
                                                                scheme),
                   bits_ref=bits_ref)

    # -- consumption --------------------------------------------------------

    def decode(self, device=None) -> PyTree:
        """Full dense params tree (torch tensors), decoded on ``device``."""
        entries: Dict[Tuple[PathToken, ...], Any] = {}
        for ks, leaf in self.packed.items():
            entries[path_tokens(ks)] = leaf.decode(device)
        for ks, arr in self.dense.items():
            entries[path_tokens(ks)] = torch.from_numpy(
                np.array(arr)).to(device)
        return unflatten_paths(entries)

    def _serves_quantized(self, ks: str, leaf: PackedLeaf
                          ) -> Tuple[bool, str]:
        """Shared eligibility rule of :meth:`serving_params` and
        :meth:`leaf_coverage` — (serves_quantized, reason)."""
        tokens = path_tokens(ks)
        if not isinstance(tokens[-1], str):
            return False, "non-string leaf key: dense-decoded"
        mshape = leaf.shape[1:] if leaf.grouped else leaf.shape
        if leaf.k > 256:
            return False, f"K={leaf.k} > 256: dense-decoded"
        if len(mshape) < 2:
            return False, "per-group ndim < 2: dense-decoded"
        m = DEFAULT_EXCLUDE.search(ks)
        if m:
            return False, (f"policy exclude /{m.group(0)}/: model reads "
                           "this leaf raw — dense-decoded")
        return True, ""

    def serving_params(self, quant_names: Optional[Tuple[str, ...]] = None,
                       packed: bool = False,
                       gather_names: Optional[Tuple[str, ...]] = None,
                       device=None) -> PyTree:
        """Params tree for quantized serving, on ``device``.

        ``packed=True``: ``<name>_pidx`` uint32 words (``pack_indices_2d``
        [⌈Kd/lanes⌉, N], leading G on grouped leaves; ``pack_rows``
        [V, ⌈D/lanes⌉] for ``gather_names`` tables), ``<name>_cb`` f32 and
        ``<name>_layout``.  ``packed=False``: the uint8 oracle layout
        ``<name>_idx`` + ``<name>_cb`` in the leaf dtype.  Leaves outside
        ``quant_names`` (when given) or not eligible decode dense.  The
        unpacking and repacking run on ``device``.
        """
        if gather_names is None:
            gather_names = self.GATHER_NAMES
        entries: Dict[Tuple[PathToken, ...], Any] = {}
        for ks, leaf in self.packed.items():
            tokens = path_tokens(ks)
            name = tokens[-1]
            eligible, _ = self._serves_quantized(ks, leaf)
            if not (eligible
                    and (quant_names is None or name in quant_names)):
                entries[tokens] = leaf.decode(device)
                continue
            mshape = leaf.shape[1:] if leaf.grouped else leaf.shape
            idx = leaf.indices(device)
            if packed:
                cb = torch.from_numpy(np.asarray(leaf.codebook, np.float32))
                kd = int(np.prod(mshape[:-1]))
                n = int(mshape[-1])
                row_packed = (name in gather_names and not leaf.grouped
                              and len(mshape) == 2)
                if row_packed:
                    words = pack_lanes_torch(idx.reshape(kd, n), leaf.k, 1)
                elif leaf.grouped:
                    words = pack_lanes_torch(idx.reshape(-1, kd, n), leaf.k,
                                             1)
                else:
                    words = pack_lanes_torch(idx.reshape(kd, n), leaf.k, 0)
                entries[tokens[:-1] + (f"{name}_pidx",)] = words
                entries[tokens[:-1] + (f"{name}_layout",)] = (
                    PackedLayout.make(kd, n, leaf.k,
                                      shape=mshape if len(mshape) != 2
                                      else None,
                                      dtype=leaf.dtype,
                                      order="row" if row_packed else "kd"))
            else:
                cb = torch.from_numpy(np.asarray(leaf.codebook, np.float32)
                                      ).to(torch_dtype(leaf.dtype))
                entries[tokens[:-1] + (f"{name}_idx",)] = idx.to(torch.uint8)
            entries[tokens[:-1] + (f"{name}_cb",)] = cb.to(device)
        for ks, arr in self.dense.items():
            entries[path_tokens(ks)] = torch.from_numpy(
                np.array(arr)).to(device)
        return unflatten_paths(entries)

    def leaf_coverage(self, gather_names: Optional[Tuple[str, ...]] = None
                      ) -> List[Dict[str, Any]]:
        """Per-leaf coverage rows (same rule as :meth:`serving_params`)."""
        if gather_names is None:
            gather_names = self.GATHER_NAMES
        rows: List[Dict[str, Any]] = []
        for ks, leaf in sorted(self.packed.items()):
            served, reason = self._serves_quantized(ks, leaf)
            name = path_tokens(ks)[-1]
            mshape = leaf.shape[1:] if leaf.grouped else leaf.shape
            row_packed = (name in gather_names and not leaf.grouped
                          and len(mshape) == 2)
            if not served:
                route = None
            elif row_packed:
                route = "qembed+qmatmul_t (pack_rows)"
            else:
                route = "qmatmul (pack_indices_2d)"
            rows.append({"path": ks, "shape": tuple(leaf.shape),
                         "quantized": served, "k": leaf.k,
                         "bits": leaf.bits if served else None,
                         "bytes_per_weight": leaf.bits / 8 if served
                         else None,
                         "route": route,
                         "reason": reason})
        for ks, arr in sorted(self.dense.items()):
            m = DEFAULT_EXCLUDE.search(ks)
            if m:
                reason = f"policy exclude: /{m.group(0)}/"
            elif np.ndim(arr) < 2:
                reason = f"ndim {np.ndim(arr)} < 2"
            else:
                reason = "excluded by qspec policy"
            rows.append({"path": ks, "shape": tuple(np.shape(arr)),
                         "quantized": False, "k": None, "bits": None,
                         "bytes_per_weight": None, "route": None,
                         "reason": reason})
        return rows

    # -- accounting (paper eq. 14) ------------------------------------------

    @property
    def p1(self) -> int:
        return sum(leaf.size for leaf in self.packed.values())

    @property
    def p0(self) -> int:
        return sum(int(a.size) for a in self.dense.values())

    def ratio(self) -> float:
        return compression_ratio(self.p1, self.p0, self.k,
                                 self.codebook_entries, b=self.bits_ref)

    def summary(self) -> Dict[str, Any]:
        return {
            "scheme": self.scheme_spec,
            "k": self.k,
            "bits_per_weight": bits_per_index(self.k),
            "p1": self.p1,
            "p0": self.p0,
            "codebook_entries": self.codebook_entries,
            "ref_bytes": (self.p1 + self.p0) * self.bits_ref // 8,
            "packed_bytes": quantized_bytes(self.p1, self.p0, self.k,
                                            self.codebook_entries,
                                            b=self.bits_ref),
            "ratio": self.ratio(),
        }

    # -- persistence --------------------------------------------------------

    def save(self, directory: str) -> str:
        """Write ``manifest.json`` (version 2: per-array sha256, dtype,
        shape, totals) + ``arrays.npz`` — the reference's format."""
        os.makedirs(directory, exist_ok=True)
        arrays: Dict[str, np.ndarray] = {}
        integrity: Dict[str, Dict[str, Any]] = {}

        def add(key: str, arr: np.ndarray):
            arrays[key] = arr
            integrity[key] = {"sha256": _array_sha256(arr),
                              "dtype": str(np.asarray(arr).dtype),
                              "shape": list(np.shape(arr))}

        manifest: Dict[str, Any] = {
            "version": 2, "scheme": self.scheme_spec, "k": self.k,
            "codebook_entries": self.codebook_entries,
            "bits_ref": self.bits_ref, "packed": [], "dense": [],
        }
        for i, (ks, leaf) in enumerate(sorted(self.packed.items())):
            add(f"p{i}_words", leaf.words)
            add(f"p{i}_cb", leaf.codebook)
            manifest["packed"].append({"path": ks, "shape": list(leaf.shape),
                                       "k": leaf.k, "dtype": leaf.dtype})
        for j, (ks, arr) in enumerate(sorted(self.dense.items())):
            add(f"d{j}", arr)
            manifest["dense"].append({"path": ks})
        manifest["arrays"] = integrity
        manifest["n_arrays"] = len(arrays)
        manifest["total_elements"] = int(sum(int(np.asarray(a).size)
                                             for a in arrays.values()))
        np.savez(os.path.join(directory, "arrays.npz"), **arrays)
        with open(os.path.join(directory, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        return directory

    @classmethod
    def load(cls, directory: str) -> "PackedModel":
        """Load and verify an artifact (v2 fully integrity-checked; v1
        loads with a warning).  Any bad piece raises :class:`ArtifactError`
        naming the leaf."""
        man_path = os.path.join(directory, "manifest.json")
        npz_path = os.path.join(directory, "arrays.npz")
        try:
            with open(man_path) as f:
                manifest = json.load(f)
        except FileNotFoundError:
            raise ArtifactError(f"no PackedModel manifest at {man_path}")
        except ValueError as e:
            raise ArtifactError(f"unparseable manifest {man_path}: {e}")
        version = int(manifest.get("version", 1))
        if version > 2:
            raise ArtifactError(
                f"{directory}: manifest version {version} is newer than "
                f"this reader (knows <= 2)")
        try:
            data = np.load(npz_path)
        except FileNotFoundError:
            raise ArtifactError(f"no PackedModel arrays at {npz_path}")
        except Exception as e:   # zipfile.BadZipFile, OSError, ...
            raise ArtifactError(f"unreadable arrays.npz at {npz_path}: "
                                f"{e!r}")

        def fetch(key: str, owner: str) -> np.ndarray:
            if key not in data.files:
                raise ArtifactError(
                    f"{directory}: arrays.npz is missing {key!r} "
                    f"(leaf {owner!r}) — truncated artifact?")
            try:
                arr = data[key]
            except Exception as e:
                raise ArtifactError(
                    f"{directory}: cannot decode {key!r} (leaf "
                    f"{owner!r}): {e!r}")
            if version >= 2:
                rec = manifest["arrays"].get(key)
                if rec is None:
                    raise ArtifactError(
                        f"{directory}: manifest has no integrity record "
                        f"for {key!r} (leaf {owner!r})")
                if (str(arr.dtype) != rec["dtype"]
                        or list(arr.shape) != list(rec["shape"])):
                    raise ArtifactError(
                        f"{directory}: {key!r} (leaf {owner!r}) is "
                        f"{arr.dtype}{list(arr.shape)}, manifest says "
                        f"{rec['dtype']}{rec['shape']}")
                got = _array_sha256(arr)
                if got != rec["sha256"]:
                    raise ArtifactError(
                        f"{directory}: {key!r} (leaf {owner!r}) failed "
                        f"integrity check: sha256 {got[:12]}… != manifest "
                        f"{rec['sha256'][:12]}…")
            return arr

        with data:
            if version < 2:
                warnings.warn(
                    f"PackedModel at {directory} has a version-{version} "
                    f"manifest (no per-array integrity data); loading "
                    f"unverified — re-save to upgrade", stacklevel=2)
            elif int(manifest.get("n_arrays", -1)) != len(data.files):
                raise ArtifactError(
                    f"{directory}: arrays.npz holds {len(data.files)} "
                    f"arrays, manifest expects {manifest.get('n_arrays')}")
            packed = {}
            for i, rec in enumerate(manifest["packed"]):
                packed[rec["path"]] = PackedLeaf(
                    words=fetch(f"p{i}_words", rec["path"]),
                    codebook=fetch(f"p{i}_cb", rec["path"]),
                    shape=tuple(rec["shape"]), k=int(rec["k"]),
                    dtype=rec["dtype"])
            dense = {rec["path"]: fetch(f"d{j}", rec["path"])
                     for j, rec in enumerate(manifest["dense"])}
        return cls(packed=packed, dense=dense,
                   scheme_spec=manifest["scheme"], k=int(manifest["k"]),
                   codebook_entries=int(manifest["codebook_entries"]),
                   bits_ref=int(manifest["bits_ref"]))
