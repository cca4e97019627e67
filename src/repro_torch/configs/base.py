"""Configuration system of the port: a copy of ``repro.configs.base``.

Every architecture is described by a :class:`ModelConfig`. Configs are pure
data (dataclasses), printed into result files and reduced for CPU tests via
:meth:`ModelConfig.reduced`; the dataclasses are the reference's, field for
field, so a config means the same thing in both packages.

``attention_impl`` stays in :class:`ModelConfig` so that configs compare
equal across the two packages, but in the port it selects nothing: the
attention path is chosen by the tensors' device (a CUDA tensor runs the
hand-written kernels, a CPU tensor their plain PyTorch versions; see
``repro_torch.kernels``). The same holds for the SSD and RG-LRU scans.

Every architecture of the reference is registered (``repro_torch.configs``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Input shapes (assigned, fixed by the task)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Sub-configs for architecture families
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 0
    d_expert: int = 0            # per-expert FFN hidden size
    num_shared_experts: int = 0  # deepseek-style always-on experts
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    first_k_dense: int = 0       # deepseek: first k layers are dense MLP
    dense_d_ff: int = 0          # hidden size of those dense layers


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (MiniCPM3 / DeepSeek-V3)."""
    q_lora_rank: int = 0          # 0 => full-rank q projection
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD."""
    state_dim: int = 128
    head_dim: int = 64            # P in SSD
    num_heads: int = 0            # derived d_inner // head_dim if 0
    expand: int = 2
    chunk_size: int = 256
    conv_width: int = 4


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma / Griffin RG-LRU hybrid."""
    lru_width: int = 0            # 0 => d_model
    window: int = 2_048           # local attention window
    pattern: Tuple[str, ...] = ("rglru", "rglru", "attn")
    conv_width: int = 4


@dataclass(frozen=True)
class FrontendConfig:
    """Stub modality frontend: precomputed embeddings of the right shape."""
    kind: str = "none"            # 'none' | 'audio' | 'vision'
    num_tokens: int = 0           # frontend tokens prepended / encoder frames
    embed_dim: int = 0            # 0 => d_model


# ---------------------------------------------------------------------------
# ModelConfig
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # 'dense'|'moe'|'ssm'|'hybrid'|'encdec'|'vlm'|'audio'
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 => d_model // num_heads
    source: str = ""              # citation (arXiv / HF model card)

    # attention details
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0       # 0 => full attention
    causal: bool = True

    # family sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    frontend: FrontendConfig = field(default_factory=FrontendConfig)

    # enc-dec
    num_encoder_layers: int = 0
    encoder_seq_len: int = 0      # fixed encoder length (whisper: 1500)

    # extras
    num_mtp_modules: int = 0      # deepseek multi-token prediction
    tie_embeddings: bool = False
    norm_eps: float = 1e-5

    # numerics / impl toggles
    dtype: str = "bfloat16"
    remat: str = "full"           # 'none' | 'full' | 'dots'
    attention_impl: str = "xla"   # 'xla' | 'pallas'
    # §Perf: shard attention over query positions ('qseq' -> model axis) —
    # rescues archs whose head count does not divide the model axis
    context_parallel_attention: bool = False
    # 'gather' or 'one_hot': one-hot matmul embedding avoids GSPMD's gather
    # resharding pathology under the stacked-hypothesis (vmapped) trainer
    embedding_impl: str = "gather"
    # 'model' (train/prefill) or 'both' (decode): mesh axes for the MoE
    # dispatch buffer / expert weights (must agree — §Perf iteration 1b/1c)
    expert_parallel: str = "model"

    # serving capability flags
    supports_long_context: bool = False   # sub-quadratic decode at 500k
    supports_decode: bool = True
    max_decode_kv: int = 0        # 0 => unlimited; whisper caps decoder ctx

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # -- derived quantities -------------------------------------------------
    @property
    def q_heads_per_kv(self) -> int:
        return max(1, self.num_heads // max(1, self.num_kv_heads))

    def param_count(self) -> int:
        """Approximate total parameter count (used for rooflines / MODEL_FLOPS)."""
        d, v = self.d_model, self.vocab_size
        total = v * d                                    # embedding
        if not self.tie_embeddings:
            total += v * d                               # lm head
        total += self._block_params() * self.num_layers
        if self.moe is not None and self.moe.first_k_dense:
            # first k layers use a dense MLP instead of the MoE FFN
            moe_ffn = self._ffn_params()
            dense_ffn = 3 * d * (self.moe.dense_d_ff or self.d_ff)
            total += (dense_ffn - moe_ffn) * self.moe.first_k_dense
        if self.num_encoder_layers:
            total += self._encoder_block_params() * self.num_encoder_layers
        if self.num_mtp_modules:
            total += self._block_params() * self.num_mtp_modules + 2 * d * d
        return total

    def active_param_count(self) -> int:
        """Params active per token (MoE: only routed top-k + shared experts)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        m = self.moe
        moe_all = 3 * d * m.d_expert * m.num_experts
        moe_active = 3 * d * m.d_expert * (m.top_k + m.num_shared_experts)
        shared = 3 * d * m.d_expert * m.num_shared_experts
        per_layer_delta = (moe_all + shared) - moe_active
        return self.param_count() - per_layer_delta * self._num_moe_layers()

    def _num_moe_layers(self) -> int:
        if self.moe is None:
            return 0
        return self.num_layers - self.moe.first_k_dense + self.num_mtp_modules

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        if self.mla is not None:
            m = self.mla
            qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
            q_in = m.q_lora_rank if m.q_lora_rank else d
            p = 0
            if m.q_lora_rank:
                p += d * m.q_lora_rank
            p += q_in * self.num_heads * qk_head
            p += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            p += m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
            p += self.num_heads * m.v_head_dim * d
            return p
        p = d * self.num_heads * hd            # q
        p += 2 * d * self.num_kv_heads * hd    # k, v
        p += self.num_heads * hd * d           # o
        if self.qkv_bias:
            p += (self.num_heads + 2 * self.num_kv_heads) * hd
        return p

    def _ffn_params(self) -> int:
        d = self.d_model
        if self.moe is not None:
            m = self.moe
            p = d * m.num_experts                                  # router
            p += 3 * d * m.d_expert * m.num_experts                # routed (gated mlp)
            p += 3 * d * m.d_expert * m.num_shared_experts         # shared
            return p
        return 3 * d * self.d_ff                                   # gated mlp

    def _block_params(self) -> int:
        d = self.d_model
        if self.family == "ssm":
            s = self.ssm
            d_inner = s.expand * d
            nheads = s.num_heads or d_inner // s.head_dim
            p = d * (2 * d_inner + 2 * s.state_dim + nheads)   # in_proj (z,x,B,C,dt)
            p += d_inner * d                                   # out proj
            p += s.conv_width * (d_inner + 2 * s.state_dim)    # conv
            p += 2 * nheads + 2 * d                            # A, D, norms
            return p
        if self.family == "hybrid":
            r = self.rglru
            w = r.lru_width or d
            n_rec = sum(1 for x in r.pattern if x == "rglru")
            n_att = len(r.pattern) - n_rec
            rec = d * w * 3 + w * d + 3 * w + r.conv_width * w   # in/gates/out/conv
            att = self._attn_params()
            per = (n_rec * rec + n_att * att) / len(r.pattern)
            return int(per + self._ffn_params() + 2 * d)
        return self._attn_params() + self._ffn_params() + 2 * d

    def _encoder_block_params(self) -> int:
        return self._attn_params() + self._ffn_params() + 2 * self.d_model

    # -- reduced variant for CPU smoke tests --------------------------------
    def reduced(self) -> "ModelConfig":
        kw = dict(
            num_layers=2,
            d_model=min(self.d_model, 128),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=32,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 256),
            remat="none",
            dtype="float32",
        )
        if self.num_kv_heads == self.num_heads:
            kw["num_kv_heads"] = kw["num_heads"]
        if self.num_kv_heads == 1:
            kw["num_kv_heads"] = 1
        if self.moe is not None:
            kw["moe"] = replace(self.moe, num_experts=4, top_k=2, d_expert=64,
                                first_k_dense=min(self.moe.first_k_dense, 1),
                                dense_d_ff=min(self.moe.dense_d_ff, 256))
        if self.mla is not None:
            kw["mla"] = replace(
                self.mla, q_lora_rank=(32 if self.mla.q_lora_rank else 0),
                kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                v_head_dim=16)
        if self.ssm is not None:
            kw["ssm"] = replace(self.ssm, state_dim=16, head_dim=16, num_heads=0,
                                chunk_size=32)
        if self.rglru is not None:
            kw["rglru"] = replace(self.rglru, lru_width=0, window=32)
        if self.num_encoder_layers:
            kw["num_encoder_layers"] = 2
            kw["encoder_seq_len"] = min(self.encoder_seq_len, 64)
        if self.frontend.kind != "none":
            kw["frontend"] = replace(self.frontend, num_tokens=16, embed_dim=0)
        if self.num_mtp_modules:
            kw["num_mtp_modules"] = 1
        if self.sliding_window:
            kw["sliding_window"] = 32
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# Train / HTL configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1_000
    min_lr_ratio: float = 0.1


@dataclass(frozen=True)
class HTLConfig:
    """Hypothesis-transfer training (the paper's technique, datacenter scale)."""
    mode: str = "a2a"             # 'a2a' | 'star' | 'sync' (baseline, no HTL)
    num_collectors: int = 4       # L virtual Data Collectors on the dc axis
    local_steps: int = 8          # H steps between hypothesis-transfer rounds
    mixing_steps: int = 8         # GreedyTL-style simplex mixing iterations
    mixing_lr: float = 0.5
    # 'gd': projected-gradient through the mixed model (closest to GreedyTL);
    # 'loss_softmax': weight each hypothesis by exp(-local_loss/tau) — first-
    # order variant that avoids differentiating through the mixture (§Perf:
    # sidesteps a GSPMD resharding pathology on vmapped gathers, XLA
    # b/433785288)
    mixing_mode: str = "gd"
    mixing_tau: float = 0.1
    unbalanced_zipf_alpha: float = 0.0   # >0 => Zipf token allocation across DCs
    aggregation_threshold: float = 0.0   # paper's data-aggregation heuristic


@dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig
    shape: InputShape
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    htl: Optional[HTLConfig] = None
    seed: int = 0


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        # import all config modules lazily
        from repro_torch.configs import ALL_ARCHS  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs():
    from repro_torch.configs import ALL_ARCHS  # noqa: F401
    return dict(_REGISTRY)


def asdict(cfg) -> dict:
    return dataclasses.asdict(cfg)
