"""Tokenizers + chat templating (the port's own copy of
``aigw_tpu/tpuserve/tokenizer.py``).

- ``ByteTokenizer``: UTF-8 bytes as tokens, dependency-free; serves the
  random-weight models.
- ``HFTokenizer``: a local ``tokenizer.json`` through the ``tokenizers``
  package, imported only when such a file is named.
"""

from __future__ import annotations

from typing import Any, Protocol

from aigw_tpu_torch.schemas.openai import message_content_text


class Tokenizer(Protocol):
    bos_id: int
    eos_id: int

    def encode(self, text: str) -> list[int]: ...
    def decode(self, ids: list[int]) -> str: ...


class ByteTokenizer:
    """UTF-8 bytes as tokens 0..255; BOS=256, EOS=257."""

    bos_id = 256
    eos_id = 257

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: list[int]) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode(
            "utf-8", errors="replace"
        )


class HFTokenizer:
    def __init__(self, path: str):
        from tokenizers import Tokenizer as _T

        self._t = _T.from_file(path)
        vocab = self._t.get_vocab()
        self.bos_id = vocab.get("<|begin_of_text|>", vocab.get("<s>", 0))
        # end-of-turn token by family: Llama-3 <|eot_id|>, ChatML (Qwen)
        # <|im_end|>, GPT-style <|endoftext|>, sentencepiece </s>
        for tok in ("<|eot_id|>", "<|im_end|>", "<|end_of_text|>",
                    "<|endoftext|>", "</s>"):
            if tok in vocab:
                self.eos_id = vocab[tok]
                break
        else:
            self.eos_id = 0

    def encode(self, text: str) -> list[int]:
        return self._t.encode(text, add_special_tokens=False).ids

    def decode(self, ids: list[int]) -> str:
        return self._t.decode(ids, skip_special_tokens=True)


def load_tokenizer(source: str) -> Tokenizer:
    if source == "byte":
        return ByteTokenizer()
    return HFTokenizer(source)


def apply_chat_template(
    messages: list[dict[str, Any]], tokenizer: Tokenizer,
    template: str = "llama3",
) -> list[int]:
    """Render an OpenAI-style message list to prompt tokens: "llama3"
    (header-id layout), "chatml" (Qwen families), or a plain textual
    layout for the byte tokenizer."""
    if isinstance(tokenizer, ByteTokenizer):
        parts = []
        for m in messages:
            parts.append(f"<{m.get('role', 'user')}>: "
                         f"{message_content_text(m.get('content'))}\n")
        parts.append("<assistant>: ")
        return tokenizer.encode("".join(parts))

    if template == "chatml":
        text = ""
        for m in messages:
            role = m.get("role", "user")
            content = message_content_text(m.get("content"))
            text += f"<|im_start|>{role}\n{content}<|im_end|>\n"
        text += "<|im_start|>assistant\n"
        return tokenizer.encode(text)

    text = "<|begin_of_text|>"
    for m in messages:
        role = m.get("role", "user")
        content = message_content_text(m.get("content"))
        text += (
            f"<|start_header_id|>{role}<|end_header_id|>\n\n{content}<|eot_id|>"
        )
    text += "<|start_header_id|>assistant<|end_header_id|>\n\n"
    return tokenizer.encode(text)


class StreamingDecoder:
    """Incremental detokenizer: emits only text that can no longer change.

    Only a sliding window is re-decoded (the ids since the last committed
    boundary): the emitted delta is ``decode(window + [tok])`` minus
    ``decode(window)``. Text ending in U+FFFD (a partial UTF-8 character)
    is held back for at most a few tokens until the continuation
    arrives.
    """

    def __init__(self, tokenizer: Tokenizer):
        self._t = tokenizer
        self._ids: list[int] = []
        # ids[:prefix] are fully emitted; ids[prefix:read] is the context
        # overlap whose text is subtracted from each new decode
        self._prefix = 0
        self._read = 0

    def push(self, token_id: int) -> str:
        self._ids.append(token_id)
        new_text = self._t.decode(self._ids[self._prefix:])
        if new_text.endswith("\ufffd") and len(self._ids) - self._read < 8:
            return ""
        prefix_text = self._t.decode(self._ids[self._prefix: self._read])
        if len(new_text) <= len(prefix_text):
            return ""
        self._prefix = self._read
        self._read = len(self._ids)
        return new_text[len(prefix_text):]

    def flush(self) -> str:
        new_text = self._t.decode(self._ids[self._prefix:])
        prefix_text = self._t.decode(self._ids[self._prefix: self._read])
        self._prefix = self._read = len(self._ids)
        return new_text[len(prefix_text):]
