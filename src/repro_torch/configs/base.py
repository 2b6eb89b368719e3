"""Model/run configuration dataclasses shared by all architectures.

A field-for-field copy of ``repro.configs.base`` so that a config value
built for the JAX package runs unchanged in the port.  The port reads
``decode_kernel`` as follows:

* ``"xla"``: the plain-PyTorch attention path (``models.common._sdpa``
  over the gathered view), the port's counterpart of the XLA path;
* ``"pallas_paged"``: the hand-written CUDA split-KV kernel reading the
  page pool in place through the page table;
* ``"pallas_gather"``: the same CUDA kernel over the gathered dense view,
  the bit-identity reference of the paged path.

Serving knobs whose engine slice is not ported yet (prefix sharing,
speculative decode, chaos, integrity, adaptive, non-greedy sampling) are
kept so configs stay interchangeable; ``serve.engine.ServeEngine`` raises
on them.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # Transformer details
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_kind: str = "rms"           # rms | layer
    act: str = "swiglu"              # swiglu | gelu
    norm_eps: float = 1e-5
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_dispatch: str = "dense"      # "dense" | "sorted" (capacity-based)
    # SSM (Mamba-2)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_expand: int = 2
    # Hybrid (zamba2): shared attention block every k SSM layers
    shared_attn_every: int = 0
    # Encoder-decoder (whisper)
    enc_layers: int = 0
    enc_seq: int = 1500              # stub frame-embedding length
    # VLM: cross-attention to vision tokens every k layers
    cross_attn_every: int = 0
    n_vis_tokens: int = 1600
    # KV cache layout (serving): "contiguous" reserves a per-slot
    # (max_len, hkv, dh) ring; "paged" pools capacity into fixed-size pages
    # shared across slots via a per-slot page table (DESIGN.md §5.2).
    cache_layout: str = "contiguous"   # "contiguous" | "paged"
    kv_page_size: int = 16             # tokens per page ("paged" only)
    # Decode-attention kernel for the single-token decode step (DESIGN.md
    # §5.2).  "xla": gather a dense per-slot view and run the masked XLA
    # softmax (the default, and the prefill path always).  "pallas_paged":
    # the paged split-KV Pallas kernel dereferences the page table inside
    # the kernel and reads the pool in place — no gather copy.
    # "pallas_gather": the same kernel math over the gathered dense view;
    # this is the bit-identity reference for the paged path and the
    # gather-cost ablation arm in the benches.
    decode_kernel: str = "xla"    # "xla" | "pallas_gather" | "pallas_paged"
    # Split-K parallelism for the Pallas decode kernels.  0 = planned: the
    # serve engine bakes its CachePolicyEngine decode plan in here before
    # building the model (jitted traces need a static split count); direct
    # model users get kernels.decode_attention.ops.plan_splits' default.
    decode_splits: int = 0
    # Prefix sharing (serving, DESIGN.md §5.4): admission attaches a new
    # request to already-resident full prefix pages via the host-side radix
    # trie (serve.prefix) and refcounted page pool, prefilling only the
    # unshared suffix.  Requires the paged layout and a pure-KV decoder
    # family (dense/moe): recurrent state is not page-shareable and
    # encdec/vlm prefix KV depends on per-slot source context, so those
    # engines fall back to unshared bookkeeping.
    prefix_sharing: bool = False
    # Speculative decode (serving, DESIGN.md §5.3): an on-device n-gram
    # proposer drafts spec_k tokens per slot; one multi-token verify
    # dispatch accepts a ragged per-slot prefix and rolls the rest back.
    spec_k: int = 0                    # draft tokens per verify (0 = off)
    spec_ngram: int = 3                # suffix length for the proposer
    # Serving-time sampling (serve.sampling.Sampler); non-greedy modes
    # thread per-request PRNG keys folded from (seed, token index) so
    # outputs are independent of slot assignment order.
    sampling: str = "greedy"           # greedy | temperature | top_k | top_p
    temperature: float = 1.0
    top_k: int = 0                     # "top_k" mode: sample from k largest
    top_p: float = 1.0                 # "top_p" mode: smallest mass >= top_p
    # Request lifecycle (serving, DESIGN.md §5.5): when admission is gated
    # on an empty free list, evict the youngest resident and re-enqueue it
    # for recompute-prefill over prompt + emitted tokens (bit-identical
    # restore by construction of the (seed, token-index) sampler keys).
    preemption: bool = True
    # Chaos / fault injection (serve.chaos, DESIGN.md §5.5): seeded alloc
    # failures (paged only) and forced preemptions at wave boundaries.
    # Probabilities must stay < 1.0 or the serve loop cannot make progress.
    chaos_alloc_fail_p: float = 0.0    # P(injected alloc refusal) per alloc
    chaos_preempt_p: float = 0.0       # P(forced preemption) per wave
    chaos_seed: int = 0                # seeds every chaos RNG
    # Crash safety + KV integrity (serve.snapshot, DESIGN.md §5.6).
    # strict_invariants arms the per-wave check_invariants() sweep even
    # with no chaos knob set (CI tier-1 also arms it via the
    # REPRO_STRICT_INVARIANTS env var).  kv_integrity stamps per-page
    # fingerprints at chunk boundaries and verifies them every step,
    # quarantining + recompute-healing any corrupted page.  The remaining
    # chaos knobs inject the failures those paths exist for: seeded
    # device-side bit flips on stamped pages and a typed ChaosCrash after
    # the Nth admission wave (0 = off).  Snapshot config fingerprints
    # exclude all chaos_* knobs and strict_invariants, so a restore may
    # run with them off.
    strict_invariants: bool = False
    kv_integrity: bool = False
    chaos_share_fail_p: float = 0.0    # P(injected share refusal) per share
    chaos_corrupt_p: float = 0.0       # P(bit-flip on a stamped page) per step
    chaos_crash_after_wave: int = 0    # raise ChaosCrash after wave N (0=off)
    # Adaptive serve-tier cache policy (serve.adaptive, DESIGN.md §5.7):
    # runtime counters (prefix hit rate, page reuse distance, spec
    # acceptance, recompute cost) drive warm-prefix retention beyond
    # refcount zero (bounded by warm_pages), cost-aware preemption victim
    # selection, and per-workload-class policy selection through the
    # core.sweep exact lattice argmin, re-planned every
    # adaptive_replan_every admission waves.  Placement-only: every
    # decision moves pages/slots, never tokens — outputs stay
    # bit-identical to the static engine, so snapshot config fingerprints
    # exclude all three knobs (like the chaos knobs).
    adaptive: bool = False
    warm_pages: int = 0                # warm-cache page budget (0 = no tier)
    adaptive_replan_every: int = 4     # admission waves between re-plans
    # Numerics / sharding
    dtype: str = "bfloat16"
    vocab_pad_multiple: int = 2048   # pad vocab so `model` axis (16) divides it
    # Sub-quadratic attention available (gates the long_500k shape cell)
    subquadratic: bool = False

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab // m) * m

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_headdim else 0

    def param_count(self) -> int:
        """Analytical parameter count (used for MODEL_FLOPS = 6*N*D)."""
        d, f, v = self.d_model, self.d_ff, self.padded_vocab
        hq, hkv, dh = self.n_heads, self.n_kv_heads, self.head_dim_
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * (hq + 2 * hkv) * dh + hq * dh * d
        mlp = (3 if self.act == "swiglu" else 2) * d * f
        if self.family == "moe":
            mlp = self.n_experts * mlp + d * self.n_experts
        ssm = 0
        if self.family in ("ssm", "hybrid"):
            di, g, ds, h = self.d_inner, self.ssm_groups, self.ssm_state, self.ssm_heads
            ssm = (
                d * (2 * di + 2 * g * ds + h)      # in_proj
                + self.ssm_conv * (di + 2 * g * ds)  # conv
                + di * d + 2 * h + di              # out_proj, A/D, norm
            )
        per_layer = 2 * d  # norms
        if self.family == "ssm":
            layer = ssm + per_layer
            total = self.n_layers * layer
        elif self.family == "hybrid":
            n_shared = (
                self.n_layers // self.shared_attn_every
                if self.shared_attn_every else 0
            )
            total = self.n_layers * (ssm + per_layer) + (attn + mlp + 2 * d)
            del n_shared  # single shared block: params counted once
        elif self.family == "encdec":
            enc = self.enc_layers * (attn + mlp + per_layer)
            dec = self.n_layers * (2 * attn + mlp + 3 * d)
            total = enc + dec
        elif self.family == "vlm":
            n_cross = (
                self.n_layers // self.cross_attn_every
                if self.cross_attn_every else 0
            )
            n_self = self.n_layers - n_cross
            total = n_self * (attn + mlp + per_layer) + n_cross * (
                attn + mlp + per_layer
            )
        else:
            total = self.n_layers * (attn + mlp + per_layer)
        return int(total + emb)

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top_k + router only)."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        mlp_all = self.n_experts * (3 * d * f)
        mlp_act = self.top_k * (3 * d * f)
        return self.param_count() - self.n_layers * (mlp_all - mlp_act)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
