"""PyTorch port of ``repro`` for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference; this package mirrors its
subpackage layout and function names, keeps its public tensor layouts,
and replaces every Pallas TPU kernel on the ported path with a CUDA C++
kernel written for ``sm_90a`` (``repro_torch.kernels``).  It imports
``torch`` and ``numpy`` only — never ``jax`` and nothing of ``repro``.

Ported so far: serving a packed ``qwen1.5-0.5b``-family artifact —
``core.compression`` (artifact load/save/serving layouts) and the KV byte
accounting of ``core.kvquant``; the six serving kernels
(``quantized_gather``, ``codebook_matmul_packed``,
``codebook_matmul_packed_t``, ``blockwise_prefill``, ``page_gather``,
``paged_attention``); the dense GQA + gated-MLP model with its paged
entry points; the continuous-batching engine over dense KV pages with
greedy sampling (``engine``), its one-shot oracle (``engine.oneshot``),
and ``launch.serve`` in both modes; the quantized KV cache, MLA + MoE and
the uint8 layout; and the paper's C step (``core.quant_ops``,
``core.kmeans``, ``core.schemes``, ``core.lc``, ``core.baselines``,
``core.plan``, ``PackedModel.pack``) with the ``kmeans_assign`` and
``fixed_quant`` kernels.
"""
