"""The ext_proc message subset of ``protos/ext_proc.proto`` on the port's hand
codec (``router/protobuf.py``): the counterpart of the generated
``llmd_tpu/router/ext_proc_pb2.py``, with the same message and field names and
numbers (Envoy's public ones, so an Envoy's bytes read here)."""

from __future__ import annotations

from llmd_tpu_torch.router.protobuf import Field as F
from llmd_tpu_torch.router.protobuf import Message

__all__ = ["HeaderValue", "HeaderMap", "HttpHeaders", "HttpBody", "HttpTrailers",
           "ProcessingRequest", "HeaderValueOption", "HeaderMutation", "BodyMutation",
           "CommonResponse", "HeadersResponse", "BodyResponse", "TrailersResponse",
           "HttpStatus", "GrpcStatus", "ImmediateResponse", "ProcessingResponse"]


class HeaderValue(Message):
    FIELDS = (F(1, "key", "string"), F(2, "value", "string"), F(3, "raw_value", "bytes"))


class HeaderMap(Message):
    FIELDS = (F(1, "headers", HeaderValue, repeated=True),)


class HttpHeaders(Message):
    FIELDS = (F(1, "headers", HeaderMap), F(3, "end_of_stream", "bool"))


class HttpBody(Message):
    FIELDS = (F(1, "body", "bytes"), F(2, "end_of_stream", "bool"))


class HttpTrailers(Message):
    FIELDS = (F(1, "trailers", HeaderMap),)


class ProcessingRequest(Message):
    FIELDS = (F(2, "request_headers", HttpHeaders, oneof="request"),
              F(3, "response_headers", HttpHeaders, oneof="request"),
              F(4, "request_body", HttpBody, oneof="request"),
              F(5, "response_body", HttpBody, oneof="request"),
              F(6, "request_trailers", HttpTrailers, oneof="request"),
              F(7, "response_trailers", HttpTrailers, oneof="request"),
              F(10, "observability_mode", "bool"))


class HeaderValueOption(Message):
    # Envoy's HeaderAppendAction: 0 APPEND_IF_EXISTS_OR_ADD, 1 ADD_IF_ABSENT,
    # 2 OVERWRITE_IF_EXISTS_OR_ADD
    FIELDS = (F(1, "header", HeaderValue), F(3, "append_action", "int32"))


class HeaderMutation(Message):
    FIELDS = (F(1, "set_headers", HeaderValueOption, repeated=True),
              F(2, "remove_headers", "string", repeated=True))


class BodyMutation(Message):
    FIELDS = (F(1, "body", "bytes", oneof="mutation"),
              F(2, "clear_body", "bool", oneof="mutation"))


class CommonResponse(Message):
    CONTINUE = 0
    CONTINUE_AND_REPLACE = 1
    FIELDS = (F(1, "status", "enum"), F(2, "header_mutation", HeaderMutation),
              F(3, "body_mutation", BodyMutation), F(4, "trailers", HeaderMap),
              F(5, "clear_route_cache", "bool"))


class HeadersResponse(Message):
    FIELDS = (F(1, "response", CommonResponse),)


class BodyResponse(Message):
    FIELDS = (F(1, "response", CommonResponse),)


class TrailersResponse(Message):
    FIELDS = (F(1, "header_mutation", HeaderMutation),)


class HttpStatus(Message):
    FIELDS = (F(1, "code", "int32"),)


class GrpcStatus(Message):
    FIELDS = (F(1, "status", "uint32"),)


class ImmediateResponse(Message):
    FIELDS = (F(1, "status", HttpStatus), F(2, "headers", HeaderMutation),
              F(3, "body", "bytes"), F(4, "grpc_status", GrpcStatus),
              F(5, "details", "string"))


class ProcessingResponse(Message):
    FIELDS = (F(1, "request_headers", HeadersResponse, oneof="response"),
              F(2, "response_headers", HeadersResponse, oneof="response"),
              F(3, "request_body", BodyResponse, oneof="response"),
              F(4, "response_body", BodyResponse, oneof="response"),
              F(5, "request_trailers", TrailersResponse, oneof="response"),
              F(6, "response_trailers", TrailersResponse, oneof="response"),
              F(7, "immediate_response", ImmediateResponse, oneof="response"))
