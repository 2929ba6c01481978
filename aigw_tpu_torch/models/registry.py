"""Model registry: name → (family, config, weight source) (counterpart of
``aigw_tpu/models/registry.py``).

This slice serves the llama family. Weight sources: ``random`` (seeded
random weights at the config's widths). The reference's ``orbax:`` and
``hf:`` checkpoints wait until checkpoints are part of the repository
(ROADMAP queue 1, weight quantization and checkpoints); the mixtral
family waits for the MoE slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from aigw_tpu_torch.models import llama


@dataclass(frozen=True)
class ModelSpec:
    name: str
    family: str  # "llama"
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
    # multi-position verifier for speculative decoding; None disables
    # the engine's speculation for the family
    verify_step: Any = None


def family_fns(family: str) -> ModelFns:
    if family == "llama":
        return ModelFns(llama.init_params, llama.decode_step,
                        llama.prefill_ragged, verify_step=llama.verify_step)
    if family == "mixtral":
        raise NotImplementedError(
            "the mixtral family is ROADMAP queue 1 (MoE)")
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
