"""The port's KV-event wire (``llmd_tpu_torch/core/kv_events.py``: a msgpack
encoder and decoder written by hand for the subset the reference emits) and
its publisher (``llmd_tpu_torch/engine/kv_publisher.py``), on the CPU.

The encoder must write the bytes ``msgpack.packb(..., use_bin_type=True)``
writes (through the reference's ``encode_event_batch``): msgpack's decoders
accept any int width, so only a byte comparison shows a width that is not the
shortest. Hypothesis draws batches across every width class: hashes over the
whole int64 range, token chunks of 0-70,000 ids (fixarray, array16, array32),
``lora_id`` strings up to str32 or None, 0-3 ``extra_keys`` of 0-70,000
bytes (bin8, bin16, bin32), and all three event kinds."""

import dataclasses
import time

import numpy as np
import pytest
import zmq
from hypothesis import given, settings
from hypothesis import strategies as st

from llmd_tpu.core import kv_events as jkv
from llmd_tpu_torch.core import kv_events as tkv
from llmd_tpu_torch.engine.kv_publisher import KVEventPublisher

INT64 = (-(2**63), 2**63 - 1)
EDGES = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63 - 1,
         -1, -32, -33, -128, -129, -32768, -32769, -(2**31), -(2**31) - 1, -(2**63)]
SIZES = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536, 70_000]

_int64 = st.one_of(st.sampled_from(EDGES), st.integers(*INT64))
_size = st.one_of(st.sampled_from(SIZES), st.integers(0, 70_000))


@st.composite
def _token_chunk(draw):
    """``n`` ids spread over every int width (token ids are int32 on the
    wire's hashing side, but the codec must carry any int)."""
    n = draw(_size)
    rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
    bounds = np.array([0, 128, 256, 65536, 2**31, 2**63], dtype=np.float64)
    k = rng.integers(0, 5, n)
    mag = (bounds[k] + rng.random(n) * (bounds[k + 1] - bounds[k])).astype(np.float64)
    vals = [min(int(m), 2**63 - 1) for m in mag]
    signs = rng.random(n) < 0.3
    return [-v - 1 if s else v for v, s in zip(vals, signs)]


_text = st.one_of(
    st.text(max_size=40),
    st.builds(lambda c, n: c * n, st.characters(codec="utf-8", exclude_categories=("Cs",)),
              st.sampled_from(SIZES)))
_bytes = st.builds(lambda b, n: bytes([b]) * n, st.integers(0, 255), _size)

_stored = st.builds(
    tkv.BlockStored,
    block_hashes=st.lists(_int64, max_size=20),
    parent_block_hash=st.one_of(st.none(), _int64),
    token_ids=_token_chunk(),
    block_size=st.sampled_from([1, 16, 64, 128, 256, 4096]),
    lora_id=st.one_of(st.none(), _text),
    medium=st.sampled_from(["gpu", "cpu", "fs"]),
    extra_keys=st.lists(_bytes, max_size=3))
_removed = st.builds(tkv.BlockRemoved, block_hashes=st.lists(_int64, max_size=20),
                     medium=st.sampled_from(["gpu", "cpu", "fs"]))
_events = st.lists(st.one_of(_stored, _removed, st.just(tkv.AllBlocksCleared())),
                   max_size=4)


def _to_reference(ev):
    cls = getattr(jkv, type(ev).__name__)
    return cls(**{f.name: getattr(ev, f.name) for f in dataclasses.fields(ev)})


@settings(max_examples=60, deadline=None)
@given(events=_events, seq=st.integers(0, 2**64 - 1))
def test_encoder_bytes_equal_msgpack(events, seq):
    ref_events = [_to_reference(e) for e in events]
    port = tkv.encode_event_batch(events, seq)
    assert port == jkv.encode_event_batch(ref_events, seq)
    # each side decodes the other's bytes to the same batch
    assert jkv.decode_event_batch(port) == (seq, ref_events)
    assert tkv.decode_event_batch(port) == (seq, events)


def test_shortest_int_forms():
    """Spot checks of the widths, against msgpack's spec."""
    def one(v):
        return tkv.encode_event_batch([tkv.BlockRemoved([v])])[6:-4]  # the int alone

    assert one(-33) == b"\xd0\xdf" and one(-32) == b"\xe0" and one(128) == b"\xcc\x80"
    assert one(-129) == b"\xd1\xff\x7f" and one(2**32) == b"\xcf" + (2**32).to_bytes(8, "big")
    assert one(-(2**63)) == b"\xd3\x80" + bytes(7)
    with pytest.raises(OverflowError):
        tkv.encode_event_batch([tkv.BlockRemoved([2**64])])


def test_topic_and_refusals_match_reference():
    assert tkv.kv_topic("10.0.0.1:8000", "m/x") == jkv.kv_topic("10.0.0.1:8000", "m/x")
    with pytest.raises(TypeError):
        tkv.encode_event_batch([object()])
    with pytest.raises(ValueError):
        tkv.decode_event_batch(tkv.encode_event_batch([]) + b"\x00")
    with pytest.raises(ValueError):
        tkv.decode_event_batch(b"\x92\x01\x91\x91\xca\x00\x00\x00\x00")  # a float32


def _recv(sub, timeout_s=5.0):
    if not sub.poll(int(timeout_s * 1000)):
        raise AssertionError("no KV-event batch within the timeout")
    return sub.recv_multipart()


def test_publisher_batches_reach_a_pyzmq_subscriber():
    """The publisher's batches, received by a pyzmq SUB and decoded by the
    reference: topic ``kv@<address>@<model>``, ``seq`` rising by one per
    batch, events in the order the sink took them."""
    pub = KVEventPublisher(0, host="127.0.0.1")
    pub.start(tkv.kv_topic("127.0.0.1:1234", "m"))
    ctx = zmq.Context()
    sub = ctx.socket(zmq.SUB)
    try:
        sub.setsockopt(zmq.SUBSCRIBE, b"kv@")
        sub.connect(f"tcp://127.0.0.1:{pub.port}")
        time.sleep(0.3)  # slow joiner
        sent = [tkv.BlockStored([1, -2], None, [5, 6], 2), tkv.BlockRemoved([1]),
                tkv.AllBlocksCleared()]
        for ev in sent:
            pub.sink([ev])
            time.sleep(0.004)  # some calls land in one batch, some straddle a flush
        got, seqs = [], []
        while len(got) < len(sent):
            topic, payload = _recv(sub)
            assert topic == b"kv@127.0.0.1:1234@m"
            seq, events = jkv.decode_event_batch(payload)
            seqs.append(seq)
            got += events
        assert got == [_to_reference(e) for e in sent]
        assert seqs == list(range(1, len(seqs) + 1))
    finally:
        pub.stop()
        sub.close(0)
        ctx.term()


def test_publisher_refuses_a_port_in_use():
    ctx = zmq.Context()
    held = ctx.socket(zmq.PUB)
    try:
        port = held.bind_to_random_port("tcp://127.0.0.1")
        pub = KVEventPublisher(port, host="127.0.0.1")
        with pytest.raises(zmq.ZMQError):
            pub.start("kv@x@m")
        pub.stop()
    finally:
        held.close(0)
        ctx.term()
