"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512) + 2 shared / 64 routed
top-6 MoE.  27L d_model=2048 16H d_ff_expert=1408 vocab=102400.
[arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2-Lite]
First layer uses a dense FFN (intermediate 10944), layers 2..27 are MoE —
expressed as two stacks.
"""
from repro_torch.models.transformer import (LayerKind, MLASpec, ModelConfig,
                                            MoESpec, StackSpec)


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        d_model=2048,
        n_heads=16,
        n_kv=16,
        head_dim=192,            # MLA: nope 128 + rope 64
        d_ff=10944,              # dense FFN of layer 1
        vocab=102400,
        stacks=(
            StackSpec(pattern=(LayerKind("mla", "dense"),), groups=1),
            StackSpec(pattern=(LayerKind("mla", "moe"),), groups=26),
        ),
        mlp_act="silu",
        gated_mlp=True,
        moe=MoESpec(n_experts=64, top_k=6, n_shared=2, d_ff_expert=1408),
        mla=MLASpec(kv_lora=512, rope_dim=64, nope_dim=128, v_dim=128),
        rope_theta=10000.0,
    )
