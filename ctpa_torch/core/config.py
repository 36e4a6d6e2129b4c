"""Typed configuration — an own copy of the dataclasses of
``ctpa/core/config.py`` that this package needs (the port imports nothing of
``ctpa``).  Field names and defaults are the same, so a ``ctpa`` config maps
field by field; fields of parts not ported yet (dropout) are left out.  The LLM configs are copied whole; the models
raise on the values whose paths are not ported (``models/llm.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class PreprocessConfig:
    """Canonical CT preprocessing parameters.  Train and inference windowings
    differ on purpose (train: clip +-1000 HU then /1000; inference: clip
    [-1000, 200] then (x+400)/600), as in the reference pipeline."""

    hu_min: float = -1000.0
    hu_max: float = 1000.0
    hu_shift: float = 0.0
    hu_scale: float = 1000.0
    target_spacing: tuple[float, float, float] = (1.5, 0.75, 0.75)
    target_shape: tuple[int, int, int] = (240, 480, 480)
    pad_value: float = -1.0

    @staticmethod
    def train() -> "PreprocessConfig":
        return PreprocessConfig(hu_min=-1000.0, hu_max=1000.0, hu_shift=0.0, hu_scale=1000.0)

    @staticmethod
    def inference() -> "PreprocessConfig":
        return PreprocessConfig(hu_min=-1000.0, hu_max=200.0, hu_shift=400.0, hu_scale=600.0)


@dataclass(frozen=True)
class CTViTConfig:
    """3D vision tower at the shipped CT-CLIP geometry."""

    dim: int = 512
    codebook_size: int = 8192
    image_size: int = 480           # spatial H = W
    patch_size: int = 20
    temporal_size: int = 240        # axial slices
    temporal_patch_size: int = 10
    spatial_depth: int = 4
    temporal_depth: int = 4
    dim_head: int = 32
    heads: int = 8
    channels: int = 1
    ff_mult: int = 4
    use_vq: bool = True
    # build the generative decoder (decode_tokens, reconstruct)
    use_decoder: bool = False
    # reproduce the reference PEG's temporal-fold layout scramble (needed for
    # checkpoints trained with it; see ctpa's CTViTConfig)
    peg_reference_layout: bool = False
    # project self-attention K/V from the LayerNormed tokens (False keeps the
    # reference quirk: K/V from the un-normalized input)
    attn_kv_from_normed: bool = False
    vq_decay: float = 0.99          # EMA codebook decay
    # exact full-sequence attention over all t*h*w tokens through the flash
    # kernels (no bias), fused_depth blocks, instead of the axial folds
    fused_attention: bool = False
    fused_depth: int = 4
    # route the spatial fold's attention through the flash-attention kernel
    # (csrc/flash_attention.cu) on CUDA tensors
    flash_axial: bool = False
    # route the patch embed through the fused patchify kernel
    # (csrc/patchify.cu) on CUDA tensors; the name is kept from ctpa
    pallas_patchify: bool = False

    @property
    def spatial_tokens(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def temporal_tokens(self) -> int:
        return self.temporal_size // self.temporal_patch_size

    @property
    def patch_dim(self) -> int:
        return self.channels * self.temporal_patch_size * self.patch_size * self.patch_size

    @staticmethod
    def tiny() -> "CTViTConfig":
        return CTViTConfig(
            dim=64, codebook_size=64, image_size=32, patch_size=8,
            temporal_size=16, temporal_patch_size=4, spatial_depth=1,
            temporal_depth=1, dim_head=16, heads=4,
        )


@dataclass(frozen=True)
class BertConfig:
    """Text tower, BERT-base geometry (CXR-BERT)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12

    @staticmethod
    def tiny() -> "BertConfig":
        return BertConfig(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                          intermediate_size=128, max_position_embeddings=128)


@dataclass(frozen=True)
class CTCLIPConfig:
    """Dual-encoder CLIP with ctpa's loss variants: decoupled contrastive
    learning, CLOOB-style extra projections, the downsampled image embedding,
    FILIP all-token similarity, the MLM head, and the SSL weights of the
    train step (``train/clip_trainer.py``).  ``gather_negatives`` is kept so
    a ctpa config maps field by field; on one device there is nothing to
    gather."""

    dim_latent: int = 512
    dim_text: int = 768
    dim_image: int = 294912         # 24*24*512 after temporal mean-pool + flatten
    temperature_init: float = 1.0   # log-temperature, exp'd at use
    decoupled_contrastive_learning: bool = False
    extra_latent_projection: bool = False   # CLOOB-style
    downsample_image_embeds: bool = False
    use_all_token_embeds: bool = False      # FILIP (dim_image = the token width)
    use_mlm: bool = False
    text_ssl_loss_weight: float = 0.05
    image_ssl_loss_weight: float = 0.05
    multiview_loss_weight: float = 0.1      # weight of the augmented-view InfoNCE
    gather_negatives: bool = True

    @staticmethod
    def tiny(vit: CTViTConfig, bert: BertConfig) -> "CTCLIPConfig":
        s = vit.image_size // vit.patch_size
        return CTCLIPConfig(dim_latent=32, dim_text=bert.hidden_size,
                            dim_image=s * s * vit.dim)


@dataclass(frozen=True)
class MeshConfig:
    """The (data, model) mesh's axis names and sizes: data parallelism and
    tensor parallelism (``core/mesh.py:create_mesh``)."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1     # -1: every rank the model axis leaves
    model_parallel: int = 1


@dataclass(frozen=True)
class OptimizerConfig:
    """AdamW with weight decay on parameters of ndim >= 2 only, global-norm
    gradient clipping and a per-step learning rate."""

    name: str = "adamw"             # 'adam' (wd=0) or 'adamw'
    lr: float = 1.25e-6
    weight_decay: float = 1e-2      # applied only to params with ndim >= 2
    betas: tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    grad_clip_norm: float = 0.5
    schedule: str = "constant"      # constant | cosine_warmup_restarts | onecycle | cosine
    warmup_steps: int = 10000
    total_steps: int = 100001
    min_lr_ratio: float = 0.0


@dataclass(frozen=True)
class TrainConfig:
    num_train_steps: int = 100001
    save_model_every: int = 2000
    save_results_every: int = 2000
    precision: str = "bf16"         # activations/compute dtype; params fp32
    results_dir: str = "results"
    checkpoint_dir: str = "checkpoints"


@dataclass(frozen=True)
class LoRAConfig:
    """LoRA overlay on the attention projections."""

    rank: int = 16
    alpha: float = 32.0
    dropout: float = 0.0
    target_projections: tuple[str, ...] = ("q_proj", "v_proj", "k_proj", "o_proj")


@dataclass(frozen=True)
class LLMConfig:
    """Decoder-only LLM, Meditron-7B (llama-2) geometry by default.  The
    comments name what each switch selects in ctpa."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    intermediate_size: int = 11008
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # no-cache forwards of at least flash_min_len tokens through the flash
    # kernel with causal + key masks (report training)
    flash_prefill: bool = False
    flash_min_len: int = 512
    # quantized serving weights: None | "int8" | "int4"
    weight_quant: Optional[str] = None
    # quant_impl, quant_fused, kv_quant_group and kv_scale_dtype act only on
    # the quantized-weight and int4-cache paths: the port accepts their
    # defaults and refuses any other value
    quant_impl: str = "pallas"           # "pallas" | "xla"
    quant_fused: bool = True
    quant_ffn_kernel: bool = False       # the fused quantized SwiGLU
    quant_act: bool = False              # w8a8 / w4a8 activations
    # quantized KV cache: None | "int8" (per-(kv-head, token) absmax scales)
    # | "int4" (not ported yet)
    kv_quant: Optional[str] = None
    kv_quant_group: int = 32
    kv_scale_dtype: str = "float32"
    kv_int8_dots: bool = False           # int8 x int8 attention dots (not ported yet)
    # single-token cached attention through the decode-attention kernel
    # (csrc/decode_attention.cu on CUDA tensors)
    flash_decode: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def tiny() -> "LLMConfig":
        return LLMConfig(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                         num_kv_heads=2, intermediate_size=128, max_seq_len=256)


@dataclass(frozen=True)
class ReportGenConfig:
    """Report generation: the vision feature width, decoding defaults and the
    training knobs of the report trainer."""

    vision_dim: int = 512
    max_new_tokens: int = 512
    temperature: float = 0.7
    max_prompt_len: int = 128
    llm_lr: float = 2e-5
    cross_attn_lr: float = 1e-4
    lora: LoRAConfig = field(default_factory=LoRAConfig)
