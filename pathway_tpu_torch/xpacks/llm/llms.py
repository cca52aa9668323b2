"""The RAG path's chat models (the port of
``pathway_tpu/xpacks/llm/llms.py``; reference: xpacks/llm/llms.py:43-771).

Every chat is a :class:`BaseChat`: called on a message list (or a
question) it answers it; called on a column expression it gives the
``ApplyExpression`` that answers each row.  ``TorchChat`` runs the port's
decoder on the card; the question answerers
(``xpacks/llm/question_answering.py``) call it from their expressions,
or its :meth:`TorchChat.generate_batch` through a request scheduler.
``OpenAIChat`` / ``LiteLLMChat`` call their client packages,
``HFPipelineChat`` a local transformers pipeline, ``BedrockChat`` the
Converse REST API signed with SigV4 (``io/_aws.py``); ``CohereChat``
raises, as in the JAX package.
"""

from __future__ import annotations

import os

from ..._device import resolve_device
from ...internals import dtype as dt
from ...internals.expression import ApplyExpression, ColumnExpression
from ...models.decoder import DecoderConfig, TorchDecoderLM


def prompt_chat_single_qa(question: str) -> list[dict]:
    return [{"role": "user", "content": question}]


def _messages(messages) -> list[dict]:
    """A message list from a message list, a question or a ``Json``."""
    if isinstance(messages, str):
        return prompt_chat_single_qa(messages)
    if hasattr(messages, "value"):
        return messages.value
    return messages


def _prompt_text(messages) -> str:
    """A message list (or a bare question) as the decoder's prompt text:
    one ``role: content`` line per message, as ``JaxChat`` writes it."""
    return "\n".join(f"{m.get('role', 'user')}: {m.get('content', '')}"
                     for m in _messages(messages))


class BaseChat:
    """Callable on expressions; subclasses implement _call_llm(messages)."""

    def _call_llm(self, messages: list[dict], **kwargs) -> str:
        raise NotImplementedError

    def _accepts_call_arg(self, arg_name: str) -> bool:
        return True

    def __call__(self, messages, **kwargs):
        """The answer to a message list or a question string; on a column
        expression, the expression answering each row (a ``None`` row
        stays ``None``)."""
        if isinstance(messages, ColumnExpression):
            def fn(msgs):
                return self._call_llm(_messages(msgs), **kwargs)

            return ApplyExpression(fn, dt.STR, (messages,), {},
                                   propagate_none=True)
        return self._call_llm(_messages(messages), **kwargs)


class TorchChat(BaseChat):
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


class OpenAIChat(BaseChat):
    """OpenAI's chat completions through the ``openai`` client.
    ``capacity``, ``cache_strategy`` and ``retry_strategy`` are accepted
    and ignored, as in the JAX package."""

    def __init__(self, model: str = "gpt-4o-mini", *,
                 api_key: str | None = None, capacity=None,
                 cache_strategy=None, retry_strategy=None, **kwargs):
        self.model = model
        self.api_key = api_key
        self.kwargs = kwargs

    def _call_llm(self, messages, **kwargs) -> str:
        try:
            import openai
        except ImportError as exc:
            raise ImportError("OpenAIChat requires the openai package") from exc
        client = openai.OpenAI(api_key=self.api_key)
        res = client.chat.completions.create(
            model=self.model, messages=messages, **{**self.kwargs, **kwargs})
        return res.choices[0].message.content


class LiteLLMChat(BaseChat):
    """Any model ``litellm.completion`` reaches."""

    def __init__(self, model: str, *, cache_strategy=None,
                 retry_strategy=None, **kwargs):
        self.model = model
        self.kwargs = kwargs

    def _call_llm(self, messages, **kwargs) -> str:
        try:
            import litellm
        except ImportError as exc:
            raise ImportError("LiteLLMChat requires litellm") from exc
        res = litellm.completion(model=self.model, messages=messages,
                                 **{**self.kwargs, **kwargs})
        return res["choices"][0]["message"]["content"]


class HFPipelineChat(BaseChat):
    """A local HuggingFace ``text-generation`` pipeline (transformers and
    the weights must be on the machine).  ``device`` defaults to the
    card, as every entry point of the port does."""

    def __init__(self, model: str, *, device="cuda", call_kwargs=None,
                 **kwargs):
        from transformers import pipeline

        self._pipe = pipeline("text-generation", model=model,
                              device=resolve_device(device), **kwargs)
        self.call_kwargs = call_kwargs or {}

    def _call_llm(self, messages, **kwargs) -> str:
        prompt = "\n".join(m.get("content", "") for m in messages)
        out = self._pipe(prompt, **{**self.call_kwargs, **kwargs})
        return out[0]["generated_text"]


class BedrockChat(BaseChat):
    """AWS Bedrock chat via the Converse REST API, spoken natively with
    SigV4 (reference: xpacks/llm/llms.py:771 — a boto3 wrapper; here the
    wire protocol is implemented directly, as the kinesis and dynamodb
    connectors do, with an injectable ``_http`` test seam).

    Credentials: explicit args or AWS_ACCESS_KEY_ID / AWS_SECRET_ACCESS_KEY
    / AWS_SESSION_TOKEN / AWS_REGION environment variables."""

    def __init__(self, model_id: str = "anthropic.claude-3-haiku-20240307-v1:0",
                 *, region: str | None = None, access_key: str | None = None,
                 secret_key: str | None = None,
                 session_token: str | None = None,
                 endpoint: str | None = None, max_tokens: int = 512,
                 temperature: float | None = None, capacity=None,
                 cache_strategy=None, retry_strategy=None, _http=None,
                 **kwargs):
        self.model_id = model_id
        self.region = region or os.environ.get("AWS_REGION", "us-east-1")
        self.access_key = access_key or os.environ.get("AWS_ACCESS_KEY_ID", "")
        self.secret_key = secret_key or os.environ.get(
            "AWS_SECRET_ACCESS_KEY", "")
        self.session_token = session_token or os.environ.get(
            "AWS_SESSION_TOKEN")
        self.endpoint = endpoint
        self.max_tokens = max_tokens
        self.temperature = temperature
        self._http = _http
        self.kwargs = kwargs

    def _call_llm(self, messages, **kwargs) -> str:
        from ...io._aws import AwsCredentials, aws_rest_call

        creds = AwsCredentials(self.access_key, self.secret_key, self.region,
                               self.session_token)
        system = [{"text": m.get("content", "")}
                  for m in messages if m.get("role") == "system"]
        conv = [{"role": m.get("role", "user"),
                 "content": [{"text": m.get("content", "")}]}
                for m in messages if m.get("role") != "system"]
        inference: dict = {"maxTokens": kwargs.get("max_tokens",
                                                   self.max_tokens)}
        temp = kwargs.get("temperature", self.temperature)
        if temp is not None:
            inference["temperature"] = temp
        # extra Converse inference params (topP, stopSequences, ...) pass
        # through, constructor kwargs overridden by per-call kwargs
        for k, v in {**self.kwargs, **kwargs}.items():
            if k not in ("max_tokens", "temperature") and v is not None:
                inference[k] = v
        payload: dict = {"messages": conv, "inferenceConfig": inference}
        if system:
            payload["system"] = system
        out = aws_rest_call(
            creds, "bedrock-runtime", f"/model/{self.model_id}/converse",
            payload, endpoint=self.endpoint, _http=self._http,
        )
        return out["output"]["message"]["content"][0]["text"]


class CohereChat(BaseChat):
    """Needs the cohere client, which neither package carries: a call
    raises ``ImportError``, as in the JAX package."""

    def __init__(self, model: str = "command", **kwargs):
        self.model = model

    def _call_llm(self, messages, **kwargs):
        raise ImportError("CohereChat requires the cohere package")


# the JAX package's list, TorchChat in JaxChat's place (it omits
# BedrockChat, which stays importable from this module)
__all__ = [
    "BaseChat", "TorchChat", "OpenAIChat", "LiteLLMChat", "HFPipelineChat",
    "CohereChat", "prompt_chat_single_qa",
]
