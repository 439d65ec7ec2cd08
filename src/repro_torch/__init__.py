"""PyTorch port of ``repro`` for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference; this package mirrors its
subpackage layout and function names, keeps its public tensor layouts,
and replaces every Pallas TPU kernel on the ported path with a CUDA C++
kernel written for ``sm_90a`` (``repro_torch.kernels``).  It imports
``torch`` and ``numpy`` only — never ``jax`` and nothing of ``repro``.

Ported so far (slice 1): the one-shot serving path of a packed
``qwen1.5-0.5b``-family artifact — ``core.compression`` (artifact
load/save/serving layouts), the four packed-serving kernels
(``quantized_gather``, ``codebook_matmul_packed``,
``codebook_matmul_packed_t``, ``blockwise_prefill``), the dense GQA +
gated-MLP model, ``engine.oneshot`` and ``launch.serve --no-engine``.
"""
