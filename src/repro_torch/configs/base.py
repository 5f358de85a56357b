"""Architecture + shape configuration system (the port's copy of the
reference's pure-data configs, field for field).

Every assigned architecture is a ``ModelConfig`` in its own module under
``repro_torch.configs``; ``repro_torch.configs.registry`` maps
``--arch <id>`` to it.  Shapes (train_4k / prefill_32k / decode_32k /
long_500k) are ``ShapeConfig``s shared by all LM-family archs.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    layer_period: int = 1     # MoE on layers where i % layer_period == period_offset
    period_offset: int = 0
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) mixer configuration."""
    state: int = 128          # N: SSM state size per head
    head_dim: int = 64        # P: channels per SSD head
    expand: int = 2           # d_inner = expand * d_model
    conv_kernel: int = 4
    chunk: int = 256          # SSD chunk length
    n_groups: int = 1         # B/C groups (GVA)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int              # query heads (attention layers); 0 => attn-free
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0         # 0 => d_model // n_heads
    mlp_type: str = "swiglu"  # swiglu | geglu | gelu
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm
    tie_embeddings: bool = False

    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig | None = None

    # hybrid layer pattern: layer i is ATTENTION iff
    #   attn_layer_period == 1  or  i % attn_layer_period == attn_layer_offset
    # (pure-SSM models set attn_layer_period=0 => no attention layers at all)
    attn_layer_period: int = 1
    attn_layer_offset: int = 0

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 0       # frames after the (stubbed) conv frontend

    # stub modality frontends: inputs carry precomputed embeddings
    frontend: str = "none"     # none | audio | vision
    n_patches: int = 0         # vision: patch embeddings prepended to the text sequence

    # numerics / runtime knobs (overridable per run)
    dtype: str = "bfloat16"
    remat_policy: str = "nothing_saveable"   # nothing_saveable | dots | none
    scan_layers: bool = True
    use_flash: str = "auto"    # auto | never  (never on CPU / dry-run)
    # causal blocked-attention schedule: "full" (rectangular, baseline) or
    # "tri" (triangular — skips fully-masked tiles, §Perf iteration 2)
    attn_schedule: str = "tri"    # confirmed §Perf iteration 2 (use "full" for baseline)
    # gradient-accumulation microbatches for the train step (§Perf lever)
    microbatches: int = 8         # fits-HBM default (§Perf iteration 4)
    # MoE dispatch locality: "shard" (per-data-shard, §Perf iteration 1) or
    # "global" (baseline: global argsort — forces token all-gather)
    moe_dispatch: str = "shard"
    # sequence-shard attention q-blocks over 'model' (for archs whose head
    # counts do not divide the model axis — §Perf iteration 3)
    attn_seq_shard: bool = False
    # sequence-parallel residual stream (perf lever, see EXPERIMENTS.md §Perf)
    seq_parallel: bool = False
    # ZeRO/FSDP: additionally shard params & opt state over the data axis
    fsdp: bool = False

    # -------------------------------------------------- derived helpers
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    def embed_scale(self) -> float | None:
        """The factor the token embeddings are multiplied by: sqrt(d_model)
        for the gemma family, None (no scaling) for the others."""
        return self.d_model ** 0.5 if self.name.startswith("gemma") else None

    def layer_is_attn(self, i: int) -> bool:
        if self.ssm is None:
            return True
        if self.attn_layer_period <= 0:
            return False
        if self.attn_layer_period == 1:
            return True
        return i % self.attn_layer_period == self.attn_layer_offset

    def layer_is_moe(self, i: int) -> bool:
        if self.moe.n_experts == 0:
            return False
        return i % self.moe.layer_period == self.moe.period_offset

    def attn_layer_ids(self) -> list[int]:
        return [i for i in range(self.n_layers) if self.layer_is_attn(i)]

    def supports_long_context(self) -> bool:
        """True iff attention cost per decoded token is sub-quadratic-friendly:
        pure SSM, or hybrid with a small fixed number of attention layers."""
        if self.is_encoder_decoder:
            return False
        if self.ssm is None:
            return False  # pure full attention
        return True       # ssm or hybrid

    def with_overrides(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode

    @property
    def is_training(self) -> bool:
        return self.kind == "train"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k":    ShapeConfig("train_4k",    seq_len=4_096,   global_batch=256, kind="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32_768,  global_batch=32,  kind="prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  seq_len=32_768,  global_batch=128, kind="decode"),
    "long_500k":   ShapeConfig("long_500k",   seq_len=524_288, global_batch=1,   kind="decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(applicable, reason-if-not). Mirrors DESIGN.md §5 skip rules."""
    if shape.name == "long_500k" and not cfg.supports_long_context():
        return False, "long_500k needs sub-quadratic attention; %s is pure full-attention" % cfg.name
    return True, ""


def smoke_reduce(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (small layers/width/vocab)."""
    kw: dict = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.ssm is None else max(4, cfg.attn_layer_period)),
        d_model=128,
        d_ff=256,
        vocab_size=512,
        scan_layers=cfg.scan_layers,
        use_flash="never",
        dtype="float32",
    )
    if cfg.n_heads:
        kw["n_heads"] = 4
        kw["n_kv_heads"] = max(1, min(cfg.n_kv_heads, 2))
        kw["head_dim"] = 32
    if cfg.moe.n_experts:
        kw["moe"] = dataclasses.replace(cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2))
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, state=16, head_dim=16, chunk=32)
    if cfg.is_encoder_decoder:
        kw["n_encoder_layers"] = 2
        kw["encoder_seq"] = 16
    if cfg.frontend == "vision":
        kw["n_patches"] = 8
    return cfg.with_overrides(**kw)
