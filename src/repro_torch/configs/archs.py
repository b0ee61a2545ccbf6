"""The 10 architectures, exact published configurations (a copy of
``repro.configs.archs``; the port serves only the ``dense`` family so far).

``ModelConfig.reduced()`` gives the small variant the CPU tests use.
"""

from repro_torch.configs.base import (
    EncDecConfig,
    MLAConfig,
    MoEConfig,
    ModelConfig,
    SSMConfig,
    XLSTMConfig,
    register,
)


@register("zamba2-1.2b")
def zamba2_1p2b() -> ModelConfig:
    """Zamba2-1.2B: Mamba2 backbone + shared attention blocks.
    [arXiv:2411.15242; hf]"""
    return ModelConfig(
        arch="zamba2-1.2b",
        family="hybrid_ssm",
        n_layers=38,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=32000,
        d_head=64,
        ssm=SSMConfig(
            state_dim=64, conv_width=4, expand=2, head_dim=64, chunk=256,
            attn_every=6, shared_attention=True,
        ),
        notes="Mamba2 (SSD) mixers; one weight-shared attn+MLP block applied "
              "every 6 layers (Zamba-style shared block).",
        source="arXiv:2411.15242",
    )


@register("qwen2-0.5b")
def qwen2_0p5b() -> ModelConfig:
    """Qwen2-0.5B: dense, GQA kv=2, QKV bias. [arXiv:2407.10671; hf]"""
    return ModelConfig(
        arch="qwen2-0.5b",
        family="dense",
        n_layers=24,
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        d_ff=4864,
        vocab_size=151936,
        d_head=64,
        qkv_bias=True,
        tie_embeddings=True,
        rope_theta=1e6,
        source="arXiv:2407.10671",
    )


@register("deepseek-coder-33b")
def deepseek_coder_33b() -> ModelConfig:
    """DeepSeek-Coder-33B: llama-arch dense, GQA kv=8. [arXiv:2401.14196; hf]"""
    return ModelConfig(
        arch="deepseek-coder-33b",
        family="dense",
        n_layers=62,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=19200,
        vocab_size=32256,
        d_head=128,
        rope_theta=100000.0,
        source="arXiv:2401.14196",
    )


@register("stablelm-1.6b")
def stablelm_1p6b() -> ModelConfig:
    """StableLM-2-1.6B: dense, MHA (kv=32).
    [hf:stabilityai/stablelm-2-1_6b; unverified]"""
    return ModelConfig(
        arch="stablelm-1.6b",
        family="dense",
        n_layers=24,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=5632,
        vocab_size=100352,
        d_head=64,
        qkv_bias=False,
        notes="StableLM-2 uses 25% partial rotary; we apply full RoPE "
              "(backbone-equivalent FLOPs/memory).",
        source="hf:stabilityai/stablelm-2-1_6b",
    )


@register("llama3.2-1b")
def llama32_1b() -> ModelConfig:
    """Llama-3.2-1B: small llama3, GQA kv=8.
    [hf:meta-llama/Llama-3.2-1B; unverified]"""
    return ModelConfig(
        arch="llama3.2-1b",
        family="dense",
        n_layers=16,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=128256,
        d_head=64,
        tie_embeddings=True,
        rope_theta=500000.0,
        source="hf:meta-llama/Llama-3.2-1B",
    )


@register("qwen2-vl-7b")
def qwen2_vl_7b() -> ModelConfig:
    """Qwen2-VL-7B language backbone: M-RoPE, GQA kv=4; vision frontend is a
    stub (precomputed patch embeddings). [arXiv:2409.12191; hf]"""
    return ModelConfig(
        arch="qwen2-vl-7b",
        family="vlm",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        d_ff=18944,
        vocab_size=152064,
        d_head=128,
        qkv_bias=True,
        mrope=True,
        input_embeds=True,
        rope_theta=1e6,
        notes="Backbone only; input_specs() supplies (B, S, d_model) patch "
              "embeddings + (3, B, S) M-RoPE position ids.",
        source="arXiv:2409.12191",
    )


@register("mixtral-8x7b")
def mixtral_8x7b() -> ModelConfig:
    """Mixtral-8x7B: 8-expert top-2 MoE, GQA kv=8, sliding-window attention.
    [arXiv:2401.04088; hf]"""
    return ModelConfig(
        arch="mixtral-8x7b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=32000,
        d_head=128,
        sliding_window=4096,
        rope_theta=1e6,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=14336),
        # MoE keeps per-expert gradient buckets + the dispatch gather
        # destinations alive next to the resident shard -> larger phi_mesh
        # transient factor (launch/dryrun.py --calibrate to refine).
        overhead=1.25,
        source="arXiv:2401.04088",
    )


@register("deepseek-v2-236b")
def deepseek_v2_236b() -> ModelConfig:
    """DeepSeek-V2-236B: MLA (kv_lora=512) + 160-expert top-6 MoE with 2
    shared experts; first layer dense. [arXiv:2405.04434; hf]"""
    return ModelConfig(
        arch="deepseek-v2-236b",
        family="mla_moe",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        d_ff=1536,
        vocab_size=102400,
        mla=MLAConfig(
            kv_lora_rank=512, q_lora_rank=1536,
            rope_head_dim=64, nope_head_dim=128, v_head_dim=128,
        ),
        moe=MoEConfig(
            n_experts=160, top_k=6, n_shared_experts=2, d_ff_expert=1536,
            first_k_dense=1, dense_d_ff=12288,
        ),
        # See mixtral-8x7b: MoE transient buffers scale the phi_mesh estimate.
        overhead=1.25,
        source="arXiv:2405.04434",
    )


@register("xlstm-1.3b")
def xlstm_1p3b() -> ModelConfig:
    """xLSTM-1.3B: sLSTM + mLSTM blocks (7:1). [arXiv:2405.04517; unverified]"""
    return ModelConfig(
        arch="xlstm-1.3b",
        family="xlstm",
        n_layers=48,
        d_model=2048,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        d_head=512,
        xlstm=XLSTMConfig(
            slstm_every=8, mlstm_proj_factor=2.0, slstm_proj_factor=1.3333,
            conv_width=4,
        ),
        notes="d_ff=0: the xLSTM blocks carry their own up/down projections "
              "(mLSTM pf=2, sLSTM pf=4/3).",
        source="arXiv:2405.04517",
    )


@register("whisper-large-v3")
def whisper_large_v3() -> ModelConfig:
    """Whisper-large-v3 backbone: enc-dec transformer, conv frontend stubbed
    (precomputed frame embeddings). [arXiv:2212.04356; unverified]"""
    return ModelConfig(
        arch="whisper-large-v3",
        family="enc_dec",
        n_layers=32,
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,
        d_ff=5120,
        vocab_size=51866,
        d_head=64,
        input_embeds=True,
        enc_dec=EncDecConfig(n_encoder_layers=32, n_decoder_layers=32,
                             frontend="stub"),
        notes="32L = 32 enc + 32 dec (whisper-large). Learned absolute "
              "positions; conv frontend replaced by input_specs() frame "
              "embeddings per the assignment.",
        source="arXiv:2212.04356",
    )
