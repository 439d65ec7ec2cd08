"""qwen1.5-0.5b [dense] — 24L d_model=1024 16H (kv=16) d_ff=2816,
QKV bias, tied embeddings, vocab=151936.  [hf:Qwen/Qwen1.5-0.5B]
"""
from repro_torch.models.transformer import (LayerKind, ModelConfig,
                                            uniform_stack)


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b",
        family="dense",
        d_model=1024,
        n_heads=16,
        n_kv=16,
        head_dim=64,
        d_ff=2816,
        vocab=151936,
        stacks=uniform_stack(LayerKind("gqa", "dense"), 24),
        mlp_act="silu",
        gated_mlp=True,
        qkv_bias=True,
        tie_embeddings=True,
        rope_theta=1000000.0,
    )
