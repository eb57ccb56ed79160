"""The vLLM gRPC message subset of ``protos/vllm_grpc.proto`` on the port's
hand codec (``router/protobuf.py``): the counterpart of the generated
``llmd_tpu/router/vllm_grpc_pb2.py``, with the same names and numbers."""

from __future__ import annotations

from llmd_tpu_torch.router.protobuf import Field as F
from llmd_tpu_torch.router.protobuf import Message

__all__ = ["SamplingParams", "TokenIds", "GenerateRequest", "Completion", "UsageInfo",
           "GenerateResponse", "EmbedRequest", "EmbedResponse"]


class SamplingParams(Message):
    FIELDS = (F(1, "max_tokens", "uint32"), F(2, "temperature", "float"),
              F(3, "top_p", "float"), F(4, "top_k", "int32"), F(5, "ignore_eos", "bool"),
              F(6, "stop", "string", repeated=True))


class TokenIds(Message):
    FIELDS = (F(1, "values", "uint32", repeated=True),)


class GenerateRequest(Message):
    FIELDS = (F(1, "request_id", "string"), F(2, "model", "string"),
              F(3, "prompt", "string", oneof="input"),
              F(4, "prompt_token_ids", TokenIds, oneof="input"),
              F(5, "sampling_params", SamplingParams), F(6, "stream", "bool"),
              F(7, "lora_adapter", "string"))


class Completion(Message):
    FIELDS = (F(1, "text", "string"), F(2, "token_ids", "uint32", repeated=True),
              F(3, "finish_reason", "string"))


class UsageInfo(Message):
    FIELDS = (F(1, "prompt_tokens", "uint32"), F(2, "completion_tokens", "uint32"),
              F(3, "cached_tokens", "uint32"))


class GenerateResponse(Message):
    FIELDS = (F(1, "request_id", "string"), F(2, "outputs", Completion, repeated=True),
              F(3, "finished", "bool"), F(4, "usage", UsageInfo), F(5, "endpoint", "string"))


class EmbedRequest(Message):
    FIELDS = (F(1, "request_id", "string"), F(2, "model", "string"), F(3, "input", "string"))


class EmbedResponse(Message):
    FIELDS = (F(1, "request_id", "string"), F(2, "embedding", "float", repeated=True),
              F(3, "endpoint", "string"))
