"""Model registry: name → (family, config, weight source) (counterpart of
``aigw_tpu/models/registry.py``).

Both of the reference's families are served: llama and mixtral. Weight
sources: ``random`` (seeded random weights at the config's widths). The
reference's ``orbax:`` and ``hf:`` checkpoints wait until checkpoints
are part of the repository (ROADMAP queue 1, weight quantization and
checkpoints).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from aigw_tpu_torch.models import llama, mixtral


@dataclass(frozen=True)
class ModelSpec:
    name: str
    family: str  # "llama" | "mixtral"
    config: Any
    weights: str = "random"  # "random" | "orbax:<dir>" | "hf:<dir>"
    tokenizer: str = "byte"  # "byte" | path to tokenizer.json
    chat_template: str = "llama3"  # "llama3" | "chatml"


@dataclass(frozen=True)
class ModelFns:
    """The functional surface the serving engine drives."""

    init_params: Any
    decode_step: Any
    prefill_ragged: Any
    # the bucketed prefill programs (the reference's default backend):
    # whole prompts in a [B, S] block, and a suffix over cached pages
    # (a prefix-cache resume, or one chunk of the chunked prefill)
    prefill: Any = None
    prefill_suffix: Any = None
    # mean-pooled final hidden states (/v1/embeddings)
    hidden_states: Any = None
    # multi-position verifier for speculative decoding; None disables
    # the engine's speculation for the family
    verify_step: Any = None
    # the random weights one tensor at a time, in init_params' order
    # (the server quantizes each as it is drawn)
    iter_params: Any = None
    # entry points take ``moe_stats=True`` and then return a trailing
    # [L, E + 1] int32 routing-stats leaf; the engine turns it on for
    # MoE families
    moe_stats: bool = False


def family_fns(family: str) -> ModelFns:
    if family == "llama":
        return ModelFns(llama.init_params, llama.decode_step,
                        llama.prefill_ragged, prefill=llama.prefill,
                        prefill_suffix=llama.prefill_suffix,
                        hidden_states=llama.hidden_states,
                        verify_step=llama.verify_step,
                        iter_params=llama.iter_params)
    if family == "mixtral":
        return ModelFns(mixtral.init_params, mixtral.decode_step,
                        mixtral.prefill_ragged, prefill=mixtral.prefill,
                        prefill_suffix=mixtral.prefill_suffix,
                        hidden_states=mixtral.hidden_states,
                        verify_step=mixtral.verify_step,
                        iter_params=mixtral.iter_params, moe_stats=True)
    raise KeyError(f"unknown model family {family!r}")


_REGISTRY: dict[str, ModelSpec] = {}


def register_model(spec: ModelSpec) -> None:
    _REGISTRY[spec.name] = spec


def get_model_spec(name: str) -> ModelSpec:
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise KeyError(
        f"unknown model {name!r}; registered: {sorted(_REGISTRY)}"
    )


register_model(ModelSpec("tiny-random", "llama", llama.TINY))
register_model(ModelSpec("tiny-moe", "mixtral", mixtral.TINY_MOE))
register_model(ModelSpec("mixtral-8x7b", "mixtral", mixtral.MIXTRAL_8X7B,
                         weights="orbax:checkpoints/mixtral-8x7b"))
register_model(ModelSpec("llama-3-8b", "llama", llama.LLAMA3_8B,
                         weights="orbax:checkpoints/llama-3-8b"))
register_model(ModelSpec("qwen2-7b", "llama", llama.QWEN2_7B,
                         weights="orbax:checkpoints/qwen2-7b",
                         chat_template="chatml"))
register_model(ModelSpec("qwen2-0.5b", "llama", llama.QWEN2_05B,
                         weights="orbax:checkpoints/qwen2-0.5b",
                         chat_template="chatml"))
register_model(ModelSpec("tiny-qwen", "llama", llama.TINY_QWEN))
register_model(ModelSpec("llama-3-70b", "llama", llama.LLAMA3_70B,
                         weights="orbax:checkpoints/llama-3-70b"))
