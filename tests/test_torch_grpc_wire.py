"""The port's gRPC wire (``llmd_tpu_torch/router/grpc_wire.py``) and protobuf
codec (``router/protobuf.py`` with the ext_proc and vLLM gRPC subsets) against
independent references, on the CPU:

- **HPACK** against RFC 7541's own examples (Appendix C.2-C.6: literals,
  indexed fields, the dynamic table's contents and size after each block,
  evictions at a 256-byte table, Huffman-coded requests and responses), the
  Huffman table's completeness, and a hypothesis round trip through a small
  dynamic table that evicts and resizes.
- **gRPC against grpcio, both ways**: a grpcio client against the port's
  server and the port's client against a grpcio server, in unary,
  server-streaming and bidirectional calls, a 1 MiB message each way (past
  both the stream's and the connection's 64 KiB windows), metadata with a
  ``-bin`` key (grpcio Huffman-codes those values), an error status with a
  non-ASCII message, deadline expiry, an unknown method, a compressed call
  refused with UNIMPLEMENTED, and the concurrent-call limit.
- **protobuf**: for hypothesis-drawn messages of both subsets the port's
  bytes equal the generated modules' ``SerializeToString``, and pb2 bytes
  with unknown fields of every wire type decode to the known ones.
"""

import asyncio
import threading
import time
from concurrent import futures

import grpc
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as hs

from llmd_tpu.router import ext_proc_pb2 as ref_ext
from llmd_tpu.router import vllm_grpc_pb2 as ref_vllm
from llmd_tpu_torch.router import ext_proc_pb as port_ext
from llmd_tpu_torch.router import grpc_wire as gw
from llmd_tpu_torch.router import vllm_grpc_pb as port_vllm


def _h(text: str) -> bytes:
    return bytes.fromhex(text.replace(" ", ""))


def _fields(pairs):
    return [(n.encode(), v.encode()) for n, v in pairs]


# -- HPACK: RFC 7541 Appendix C ------------------------------------------------
C2 = [  # (block, fields, table after, table size): each with a fresh decoder
    (_h("400a 6375 7374 6f6d 2d6b 6579 0d63 7573 746f 6d2d 6865 6164 6572"),
     [("custom-key", "custom-header")], [("custom-key", "custom-header")], 55),
    (_h("040c 2f73 616d 706c 652f 7061 7468"), [(":path", "/sample/path")], [], 0),
    (_h("1008 7061 7373 776f 7264 0673 6563 7265 74"), [("password", "secret")], [], 0),
    (_h("82"), [(":method", "GET")], [], 0),
]
REQ1 = [(":method", "GET"), (":scheme", "http"), (":path", "/"),
        (":authority", "www.example.com")]
REQ2 = REQ1 + [("cache-control", "no-cache")]
REQ3 = [(":method", "GET"), (":scheme", "https"), (":path", "/index.html"),
        (":authority", "www.example.com"), ("custom-key", "custom-value")]
T1 = [(":authority", "www.example.com")]
T2 = [("cache-control", "no-cache"), (":authority", "www.example.com")]
T3 = [("custom-key", "custom-value"), ("cache-control", "no-cache"),
      (":authority", "www.example.com")]
C3 = [  # requests without Huffman, one decoder through the three
    (_h("8286 8441 0f77 7777 2e65 7861 6d70 6c65 2e63 6f6d"), REQ1, T1, 57),
    (_h("8286 84be 5808 6e6f 2d63 6163 6865"), REQ2, T2, 110),
    (_h("8287 85bf 400a 6375 7374 6f6d 2d6b 6579 0c63 7573 746f 6d2d 7661 6c75 65"),
     REQ3, T3, 164),
]
C4 = [  # the same requests, Huffman-coded
    (_h("8286 8441 8cf1 e3c2 e5f2 3a6b a0ab 90f4 ff"), REQ1, T1, 57),
    (_h("8286 84be 5886 a8eb 1064 9cbf"), REQ2, T2, 110),
    (_h("8287 85bf 4088 25a8 49e9 5ba9 7d7f 8925 a849 e95b b8e8 b4bf"), REQ3, T3, 164),
]
DATE1, DATE2 = "Mon, 21 Oct 2013 20:13:21 GMT", "Mon, 21 Oct 2013 20:13:22 GMT"
LOC = "https://www.example.com"
COOKIE = "foo=ASDJKHQKBZXOQWEOPIUAXQWEOIU; max-age=3600; version=1"
RESP1 = [(":status", "302"), ("cache-control", "private"), ("date", DATE1), ("location", LOC)]
RESP2 = [(":status", "307"), ("cache-control", "private"), ("date", DATE1), ("location", LOC)]
RESP3 = [(":status", "200"), ("cache-control", "private"), ("date", DATE2), ("location", LOC),
         ("content-encoding", "gzip"), ("set-cookie", COOKIE)]
RT1 = [("location", LOC), ("date", DATE1), ("cache-control", "private"), (":status", "302")]
RT2 = [(":status", "307"), ("location", LOC), ("date", DATE1), ("cache-control", "private")]
RT3 = [("set-cookie", COOKIE), ("content-encoding", "gzip"), ("date", DATE2)]
C5 = [  # responses without Huffman, a 256-byte table: evictions
    (_h("4803 3330 3258 0770 7269 7661 7465 611d 4d6f 6e2c 2032 3120 4f63 7420 3230 3133"
        "2032 303a 3133 3a32 3120 474d 546e 1768 7474 7073 3a2f 2f77 7777 2e65 7861 6d70"
        "6c65 2e63 6f6d"), RESP1, RT1, 222),
    (_h("4803 3330 37c1 c0bf"), RESP2, RT2, 222),
    (_h("88c1 611d 4d6f 6e2c 2032 3120 4f63 7420 3230 3133 2032 303a 3133 3a32 3220 474d"
        "54c0 5a04 677a 6970 7738 666f 6f3d 4153 444a 4b48 514b 425a 584f 5157 454f 5049"
        "5541 5851 5745 4f49 553b 206d 6178 2d61 6765 3d33 3630 303b 2076 6572 7369 6f6e"
        "3d31"), RESP3, RT3, 215),
]
C6 = [  # the same responses, Huffman-coded
    (_h("4882 6402 5885 aec3 771a 4b61 96d0 7abe 9410 54d4 44a8 2005 9504 0b81 66e0 82a6"
        "2d1b ff6e 919d 29ad 1718 63c7 8f0b 97c8 e9ae 82ae 43d3"), RESP1, RT1, 222),
    (_h("4883 640e ffc1 c0bf"), RESP2, RT2, 222),
    (_h("88c1 6196 d07a be94 1054 d444 a820 0595 040b 8166 e084 a62d 1bff c05a 839b d9ab"
        "77ad 94e7 821d d7f2 e6c7 b335 dfdf cd5b 3960 d5af 2708 7f36 72c1 ab27 0fb5 291f"
        "9587 3160 65c0 03ed 4ee5 b106 3d50 07"), RESP3, RT3, 215),
]


@pytest.mark.parametrize("section", ["C.2", "C.3", "C.4", "C.5", "C.6"])
def test_hpack_decodes_rfc7541_examples(section):
    """Every example block of RFC 7541 Appendix C decodes to its fields and
    leaves the dynamic table with the RFC's entries (newest first) and size."""
    cases = {"C.2": C2, "C.3": C3, "C.4": C4, "C.5": C5, "C.6": C6}[section]
    decoder = gw.HPACKDecoder()
    for block, fields, table, size in cases:
        if section == "C.2":
            decoder = gw.HPACKDecoder()
        if section in ("C.5", "C.6") and decoder.table.limit != 256:
            decoder.table.resize(256)  # the examples' SETTINGS_HEADER_TABLE_SIZE
        assert decoder.decode(block) == _fields(fields)
        assert list(decoder.table.entries) == _fields(table)
        assert decoder.table.size == size


def test_huffman_table_and_refusals():
    """The 257 code lengths make a complete prefix code (Kraft sum exactly 1),
    the canonical codes equal the RFC's at both ends, and a decoder refuses
    EOS in a string and padding that is not EOS's prefix or is 8 bits long."""
    from fractions import Fraction

    assert sum(Fraction(1, 2 ** n) for n in gw.HUFFMAN_LENGTHS) == 1
    codes = gw.huffman_codes()
    assert codes[48] == (0x0, 5) and codes[ord(" ")] == (0x14, 6)
    assert codes[0] == (0x1FF8, 13) and codes[255] == (0x3FFFFEE, 26)
    assert codes[gw.EOS] == (0x3FFFFFFF, 30)
    assert gw.huffman_decode(_h("f1e3 c2e5 f23a 6ba0 ab90 f4ff")) == b"www.example.com"
    for bad in (b"\xff\xff\xff\xff", b"\x00", b"\xf1\xe3\xc2\xe5\xf2\x3a\x6b\xa0\xab\x90\xf4\xff\xff"):
        with pytest.raises(gw.HPACKError):
            gw.huffman_decode(bad)
    with pytest.raises(gw.HPACKError):
        gw.HPACKDecoder().decode(b"\x80")  # index 0
    with pytest.raises(gw.HPACKError):
        gw.HPACKDecoder(max_table_size=100).decode(b"\x3f\xe1\x1f")  # size update over


_name = hs.sampled_from([b"content-type", b"x-request-id", b"grpc-status", b":path",
                         b"user-agent", b"x-custom", b"grpc-timeout"]) | hs.binary(
    min_size=1, max_size=12).map(lambda b: b.hex().encode())
_field = hs.tuples(_name, hs.binary(max_size=40))


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(blocks=hs.lists(hs.tuples(hs.lists(_field, max_size=8),
                                 hs.sampled_from([None, 0, 64, 128, 300, 4096])),
                       min_size=1, max_size=8))
def test_hpack_round_trip_evicts(blocks):
    """The encoder's blocks decode to what went in, through a dynamic table
    small enough to evict, with table-size changes between blocks; both
    sides' tables agree after every block."""
    enc, dec = gw.HPACKEncoder(), gw.HPACKDecoder()
    enc.set_max_table_size(200)
    for fields, resize in blocks:
        if resize is not None:
            enc.set_max_table_size(resize)
        assert dec.decode(enc.encode(fields)) == fields
        assert list(dec.table.entries) == list(enc.table.entries)
        assert dec.table.size == enc.table.size <= enc.table.limit


# -- gRPC against grpcio ----------------------------------------------------------
BIG = bytes(range(256)) * 4096  # 1 MiB
SVC = "/wire.test.Svc"


class _Loop:
    def __init__(self) -> None:
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def run(self, coro, timeout: float = 30):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def close(self) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(5)


async def _echo(request: bytes, context):
    md = dict(context.invocation_metadata())
    if request == b"fail":
        context.abort(gw.StatusCode.INVALID_ARGUMENT, "refusé: 100% ünïcode")
    if request == b"slow":
        await asyncio.sleep(30)
    context.set_trailing_metadata([("x-trailer-bin", b"\x00\xfe\x01"), ("x-trailer", "t")])
    return request[::-1] + md.get("x-key-bin", b"") + md.get("x-key", "").encode()


async def _count(request: bytes, context):
    for i in range(int(request)):
        yield b"%d" % i
    if request == b"3":
        context.abort(gw.StatusCode.NOT_FOUND, "after three")


async def _bidi(requests, context):
    async for m in requests:
        yield m + b"!"


@pytest.fixture(scope="module")
def port_server():
    lp = _Loop()
    server = gw.Server(maximum_concurrent_rpcs=4)
    server.add_method(f"{SVC}/Echo", "unary_unary", _echo)
    server.add_method(f"{SVC}/Count", "unary_stream", _count)
    server.add_method(f"{SVC}/Bidi", "stream_stream", _bidi)
    port = lp.run(server.start("127.0.0.1", 0))
    yield lp, server, f"127.0.0.1:{port}"
    lp.run(server.stop(0.5))
    lp.close()


def test_grpcio_client_against_port_server(port_server):
    """A grpcio channel drives the port's server: unary with metadata both
    ways (a ``-bin`` key), 1 MiB each way, a server stream, a bidirectional
    stream with a 1 MiB message in it, a status with a non-ASCII message,
    a stream ended by an abort after its messages, deadline expiry, an
    unknown method and a gzip call refused."""
    _, _, address = port_server
    with grpc.insecure_channel(address) as ch:
        echo = ch.unary_unary(f"{SVC}/Echo")
        out, call = echo.with_call(b"hello", metadata=[("x-key-bin", b"\xff\x00"),
                                                       ("x-key", "k")], timeout=10)
        assert out == b"olleh\xff\x00k"
        assert tuple(call.trailing_metadata()) == (("x-trailer-bin", b"\x00\xfe\x01"),
                                                   ("x-trailer", "t"))
        assert echo(BIG, timeout=10) == BIG[::-1]
        with pytest.raises(grpc.RpcError) as e:
            echo(b"fail", timeout=10)
        assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        assert e.value.details() == "refusé: 100% ünïcode"
        t0 = time.monotonic()
        with pytest.raises(grpc.RpcError) as e:
            echo(b"slow", timeout=0.3)
        assert e.value.code() == grpc.StatusCode.DEADLINE_EXCEEDED
        assert time.monotonic() - t0 < 5
        assert list(ch.unary_stream(f"{SVC}/Count")(b"5", timeout=10)) == [
            b"0", b"1", b"2", b"3", b"4"]
        it = ch.unary_stream(f"{SVC}/Count")(b"3", timeout=10)
        assert [next(it) for _ in range(3)] == [b"0", b"1", b"2"]
        with pytest.raises(grpc.RpcError) as e:
            next(it)
        assert (e.value.code(), e.value.details()) == (grpc.StatusCode.NOT_FOUND, "after three")
        assert list(ch.stream_stream(f"{SVC}/Bidi")(iter([b"a", BIG, b"b"]), timeout=10)) == [
            b"a!", BIG + b"!", b"b!"]
        with pytest.raises(grpc.RpcError) as e:
            ch.unary_unary(f"{SVC}/Nope")(b"x", timeout=10)
        assert e.value.code() == grpc.StatusCode.UNIMPLEMENTED
    with grpc.insecure_channel(address, compression=grpc.Compression.Gzip) as ch:
        with pytest.raises(grpc.RpcError) as e:
            ch.unary_unary(f"{SVC}/Echo")(b"x" * 100, timeout=10)
        assert e.value.code() == grpc.StatusCode.UNIMPLEMENTED


def test_port_server_limits_concurrent_calls(port_server):
    """Past ``maximum_concurrent_rpcs`` a call is refused with
    RESOURCE_EXHAUSTED (grpcio's text) while the others run on."""
    lp, server, address = port_server

    async def main():
        ch = gw.Channel(address)
        bidi = ch.stream_stream(f"{SVC}/Bidi")
        calls = [bidi() for _ in range(4)]
        for c in calls:
            await c.write(b"x")
            assert await c.read() == b"x!"
        with pytest.raises(gw.RpcError) as e:
            await ch.unary_unary(f"{SVC}/Echo")(b"y", timeout=10)
        for c in calls:
            await c.done_writing()
            assert await c.read() is None and c.code() == gw.StatusCode.OK
        assert await ch.unary_unary(f"{SVC}/Echo")(b"y", timeout=10) == b"y"
        await ch.close()
        return e.value

    err = lp.run(main())
    assert (err.code(), err.details()) == (gw.StatusCode.RESOURCE_EXHAUSTED,
                                           "Concurrent RPC limit exceeded!")


def test_port_client_against_grpcio_server():
    """The port's channel drives a grpcio server: the same calls, 1 MiB each
    way in a unary and in a bidirectional call, metadata both ways, a
    non-ASCII error, deadline expiry, an unknown method."""
    def g_echo(req, ctx):
        md = dict(ctx.invocation_metadata())
        if req == b"fail":
            ctx.abort(grpc.StatusCode.FAILED_PRECONDITION, "échec 50%")
        if req == b"slow":
            time.sleep(3)
        ctx.set_trailing_metadata((("y-bin", b"\x01\x02\x03"), ("y", "z")))
        return req[::-1] + md.get("x-key-bin", b"")

    def g_count(req, ctx):
        for i in range(int(req)):
            yield b"%d" % i

    def g_bidi(it, ctx):
        for m in it:
            yield m + b"?"

    server = grpc.server(futures.ThreadPoolExecutor(4))
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler("wire.test.Svc", {
        "Echo": grpc.unary_unary_rpc_method_handler(g_echo),
        "Count": grpc.unary_stream_rpc_method_handler(g_count),
        "Bidi": grpc.stream_stream_rpc_method_handler(g_bidi)}),))
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()

    async def main():
        ch = gw.Channel(f"127.0.0.1:{port}")
        out = {}
        call = gw.Call(ch, f"{SVC}/Echo", None, None, 10, [("x-key-bin", b"\x00\xff")])
        out["unary"] = await call._unary(b"abc")
        out["trailing"] = call.trailing_metadata()
        out["big"] = await ch.unary_unary(f"{SVC}/Echo")(BIG, timeout=10) == BIG[::-1]
        for what, req, timeout in (("fail", b"fail", 10), ("slow", b"slow", 0.3)):
            try:
                await ch.unary_unary(f"{SVC}/Echo")(req, timeout=timeout)
            except gw.RpcError as e:
                out[what] = (e.code(), e.details())
        try:
            await ch.unary_unary(f"{SVC}/Nope")(b"x", timeout=10)
        except gw.RpcError as e:
            out["nope"] = e.code()
        out["count"] = [m async for m in ch.unary_stream(f"{SVC}/Count")(b"4", timeout=10)]
        bidi = ch.stream_stream(f"{SVC}/Bidi")(timeout=10)
        await bidi.write(b"x")
        out["bidi1"] = await bidi.read()
        await bidi.write(BIG)
        out["bidi2"] = await bidi.read() == BIG + b"?"
        await bidi.done_writing()
        out["bidi_end"] = (await bidi.read(), bidi.code())
        it = ch.stream_stream(f"{SVC}/Bidi")(iter([b"1", b"2"]), timeout=10)
        out["bidi_iter"] = [m async for m in it]
        await ch.close()
        return out

    lp = _Loop()
    try:
        out = lp.run(main())
    finally:
        lp.close()
        server.stop(0)
    assert out["unary"] == b"cba\x00\xff"
    assert out["trailing"] == (("y-bin", b"\x01\x02\x03"), ("y", "z"))
    assert out["big"]
    assert out["fail"] == (gw.StatusCode.FAILED_PRECONDITION, "échec 50%")
    assert out["slow"] == (gw.StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded")
    assert out["nope"] == gw.StatusCode.UNIMPLEMENTED
    assert out["count"] == [b"0", b"1", b"2", b"3"]
    assert out["bidi1"] == b"x?" and out["bidi2"]
    assert out["bidi_end"] == (None, gw.StatusCode.OK)
    assert out["bidi_iter"] == [b"1?", b"2?"]


# -- protobuf: the hand codec against the generated modules ----------------------
_text = hs.text(hs.characters(blacklist_categories=("Cs",)), max_size=12)
_bytes = hs.binary(max_size=24)
_int32 = hs.integers(-2 ** 31, 2 ** 31 - 1)
_uint32 = hs.integers(0, 2 ** 32 - 1)
_float = hs.floats(width=32, allow_nan=False)


def _opt(**strategies):
    """A dict of some of the given fields (unset ones stay absent)."""
    return hs.fixed_dictionaries({}, optional=strategies)


_hv = _opt(key=_text, value=_text, raw_value=_bytes)
_hm = _opt(headers=hs.lists(_hv, max_size=3))
_mutation = _opt(set_headers=hs.lists(_opt(header=_hv, append_action=_int32), max_size=3),
                 remove_headers=hs.lists(_text, max_size=2))
_common = _opt(status=hs.sampled_from([0, 1]), header_mutation=_mutation,
               body_mutation=hs.one_of(_opt(body=_bytes), _opt(clear_body=hs.booleans())),
               trailers=_hm, clear_route_cache=hs.booleans())
_request = hs.one_of(
    *(hs.fixed_dictionaries({k: _opt(headers=_hm, end_of_stream=hs.booleans())})
      for k in ("request_headers", "response_headers")),
    *(hs.fixed_dictionaries({k: _opt(body=_bytes, end_of_stream=hs.booleans())})
      for k in ("request_body", "response_body")),
    *(hs.fixed_dictionaries({k: _opt(trailers=_hm)})
      for k in ("request_trailers", "response_trailers")),
    _opt(observability_mode=hs.booleans()))
_response = hs.one_of(
    *(hs.fixed_dictionaries({k: _opt(response=_common)})
      for k in ("request_headers", "response_headers", "request_body", "response_body")),
    *(hs.fixed_dictionaries({k: _opt(header_mutation=_mutation)})
      for k in ("request_trailers", "response_trailers")),
    hs.fixed_dictionaries({"immediate_response": _opt(
        status=_opt(code=_int32), headers=_mutation, body=_bytes,
        grpc_status=_opt(status=_uint32), details=_text)}))
_sampling = _opt(max_tokens=_uint32, temperature=_float, top_p=_float, top_k=_int32,
                 ignore_eos=hs.booleans(), stop=hs.lists(_text, max_size=3))
_generate = hs.tuples(
    _opt(request_id=_text, model=_text, sampling_params=_sampling, stream=hs.booleans(),
         lora_adapter=_text),
    hs.one_of(hs.just({}), _opt(prompt=_text),
              hs.fixed_dictionaries({"prompt_token_ids": _opt(
                  values=hs.lists(_uint32, max_size=6))}))).map(lambda t: {**t[0], **t[1]})
_gen_response = _opt(request_id=_text, outputs=hs.lists(_opt(
    text=_text, token_ids=hs.lists(_uint32, max_size=4), finish_reason=_text), max_size=3),
    finished=hs.booleans(), usage=_opt(prompt_tokens=_uint32, completion_tokens=_uint32,
                                       cached_tokens=_uint32), endpoint=_text)
_embed = _opt(request_id=_text, model=_text, input=_text)
_embed_response = _opt(request_id=_text, embedding=hs.lists(_float, max_size=6),
                       endpoint=_text)

# message -> {field: message class name} of its sub-messages, to build both trees
_SUB = {
    "HeaderMap": {"headers": "HeaderValue"},
    "HttpHeaders": {"headers": "HeaderMap"}, "HttpTrailers": {"trailers": "HeaderMap"},
    "ProcessingRequest": {"request_headers": "HttpHeaders", "response_headers": "HttpHeaders",
                          "request_body": "HttpBody", "response_body": "HttpBody",
                          "request_trailers": "HttpTrailers",
                          "response_trailers": "HttpTrailers"},
    "HeaderValueOption": {"header": "HeaderValue"},
    "HeaderMutation": {"set_headers": "HeaderValueOption"},
    "CommonResponse": {"header_mutation": "HeaderMutation", "body_mutation": "BodyMutation",
                       "trailers": "HeaderMap"},
    "HeadersResponse": {"response": "CommonResponse"},
    "BodyResponse": {"response": "CommonResponse"},
    "TrailersResponse": {"header_mutation": "HeaderMutation"},
    "ImmediateResponse": {"status": "HttpStatus", "headers": "HeaderMutation",
                          "grpc_status": "GrpcStatus"},
    "ProcessingResponse": {"request_headers": "HeadersResponse",
                           "response_headers": "HeadersResponse",
                           "request_body": "BodyResponse", "response_body": "BodyResponse",
                           "request_trailers": "TrailersResponse",
                           "response_trailers": "TrailersResponse",
                           "immediate_response": "ImmediateResponse"},
    "GenerateRequest": {"prompt_token_ids": "TokenIds", "sampling_params": "SamplingParams"},
    "Completion": {}, "GenerateResponse": {"outputs": "Completion", "usage": "UsageInfo"},
}


def _build(mod, name: str, d: dict):
    kw = {}
    for k, v in d.items():
        sub = _SUB.get(name, {}).get(k)
        if sub is None:
            kw[k] = v
        elif isinstance(v, list):
            kw[k] = [_build(mod, sub, x) for x in v]
        else:
            kw[k] = _build(mod, sub, v)
    return getattr(mod, name)(**kw)


_CASES = [(ref_ext, port_ext, "ProcessingRequest", _request),
          (ref_ext, port_ext, "ProcessingResponse", _response),
          (ref_vllm, port_vllm, "GenerateRequest", _generate),
          (ref_vllm, port_vllm, "GenerateResponse", _gen_response),
          (ref_vllm, port_vllm, "EmbedRequest", _embed),
          (ref_vllm, port_vllm, "EmbedResponse", _embed_response)]


@pytest.mark.parametrize("ref_mod,port_mod,name,strategy", _CASES,
                         ids=[c[2] for c in _CASES])
@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(data=hs.data())
def test_protobuf_bytes_equal_generated(ref_mod, port_mod, name, strategy, data):
    """One drawn message built in both packages: the port's bytes equal
    pb2's, and each side decodes the other's bytes back to the same message
    (field by field, oneof choice included)."""
    d = data.draw(strategy)
    ref, port = _build(ref_mod, name, d), _build(port_mod, name, d)
    wire = ref.SerializeToString()
    assert port.SerializeToString() == wire
    back = getattr(port_mod, name).FromString(wire)
    assert back.SerializeToString() == wire
    for group in {"ProcessingRequest": ["request"], "ProcessingResponse": ["response"],
                  "GenerateRequest": ["input"]}.get(name, []):
        assert back.WhichOneof(group) == ref.WhichOneof(group)


def test_protobuf_skips_unknown_fields():
    """pb2 bytes with fields the subset lacks (every wire type, at the top and
    inside sub-messages, as a real Envoy sends ``attributes`` and
    ``metadata_context``) decode to the known fields alone."""
    def varint(n):
        out = bytearray()
        while n >= 0x80:
            out.append(n & 0x7F | 0x80)
            n >>= 7
        return bytes(out + bytes([n]))

    def field(number, wire, payload):
        tag = varint(number << 3 | wire)
        return tag + (varint(len(payload)) if wire == 2 else b"") + payload

    unknown = (field(8, 2, b"\x0a\x03abc") + field(9, 0, b"\x96\x01") + field(11, 1, b"\0" * 8)
               + field(12, 5, b"\1\2\3\4") + varint(13 << 3 | 3) + field(1, 0, b"\x05")
               + varint(13 << 3 | 4) + field(300, 0, b"\x01"))
    ref = ref_ext.ProcessingRequest(request_headers=ref_ext.HttpHeaders(
        headers=ref_ext.HeaderMap(headers=[ref_ext.HeaderValue(key=":path", raw_value=b"/v1")]),
        end_of_stream=True))
    inner = ref.request_headers.SerializeToString() + field(2, 2, b"\x0a\x01x")  # attributes
    wire = unknown + field(2, 2, inner) + unknown
    assert ref_ext.ProcessingRequest.FromString(wire).SerializeToString() != b""
    port = port_ext.ProcessingRequest.FromString(wire)
    assert port.WhichOneof("request") == "request_headers"
    assert port.SerializeToString() == ref.SerializeToString()
    assert port.request_headers.headers.headers[0].raw_value == b"/v1"
    gen = ref_vllm.GenerateResponse(request_id="r", finished=True)
    port_gen = port_vllm.GenerateResponse.FromString(field(20, 2, b"zz") + gen.SerializeToString())
    assert port_gen.SerializeToString() == gen.SerializeToString()
