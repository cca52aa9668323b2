"""The RAG path's chat model.

Counterpart of ``pathway_tpu/xpacks/llm/llms.py`` ``JaxChat``: called on
a message list (or a question) it answers it.  The question answerers
(``xpacks/llm/question_answering.py``) call it from their expressions,
or its :meth:`TorchChat.generate_batch` through a request scheduler.
"""

from __future__ import annotations

import os

from ..._device import resolve_device
from ...models.decoder import DecoderConfig, TorchDecoderLM


def prompt_chat_single_qa(question: str) -> list[dict]:
    return [{"role": "user", "content": question}]


def _prompt_text(messages) -> str:
    """A message list (or a bare question) as the decoder's prompt text:
    one ``role: content`` line per message, as ``JaxChat`` writes it."""
    if isinstance(messages, str):
        messages = prompt_chat_single_qa(messages)
    elif hasattr(messages, "value"):
        messages = messages.value
    return "\n".join(f"{m.get('role', 'user')}: {m.get('content', '')}"
                     for m in messages)


class TorchChat:
    """The port's decoder LM behind a chat interface: greedy completion
    of a message list, one at a time (:meth:`__call__`, the dense
    single-stream tier) or a whole coalesced batch in one pass of the
    paged engine (:meth:`generate_batch`).  ``config`` builds random
    weights from ``seed`` unless ``params`` are given; ``model`` naming
    an existing local path loads GPT-2-family weights through
    ``TorchDecoderLM.from_hf`` (``params``, when given, replace them, as
    in ``JaxChat``); any other ``model`` is a label."""

    def __init__(self, config=None, *, seed: int = 0,
                 max_new_tokens: int = 64, params=None,
                 model: str | None = None, device="cuda"):
        dev = resolve_device(device)
        self.model_name = model or "pathway-tpu-decoder"
        if model is not None and config is None and os.path.exists(model):
            self._lm = TorchDecoderLM.from_hf(model, device=dev)
            if params is not None:
                self._lm.params = params
        else:
            self._lm = TorchDecoderLM(config or DecoderConfig(), seed=seed,
                                      params=params, device=dev)
        self.max_new_tokens = max_new_tokens

    def _call_llm(self, messages: list[dict], **kwargs) -> str:
        return self._lm.generate(
            _prompt_text(messages),
            max_new_tokens=kwargs.get("max_tokens", self.max_new_tokens),
        )

    def __call__(self, messages, **kwargs) -> str:
        """The answer to a message list, or to a question string."""
        return self._call_llm(messages, **kwargs)

    def paged_engine(self):
        """The paged KV decode engine behind :meth:`generate_batch` (a
        scheduler in front of this chat sizes its batches from it)."""
        return self._lm.paged_engine()

    def generate_batch(self, message_batches: list, **kwargs) -> list[str]:
        """Answer a whole coalesced batch in ONE pass of the paged KV
        engine (mixed lengths, shared-prefix blocks mapped to the same
        physical blocks)."""
        return self._lm.generate_batch(
            [_prompt_text(m) for m in message_batches],
            max_new_tokens=kwargs.get("max_tokens", self.max_new_tokens),
        )


__all__ = ["TorchChat", "prompt_chat_single_qa"]
