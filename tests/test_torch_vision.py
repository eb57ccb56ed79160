"""The port's vision tower and encode helpers (``llmd_tpu_torch/models/vision.py``,
``llmd_tpu_torch/disagg/encode.py``) against the JAX package, on the CPU.

Both sides get the same numpy inputs: tower params drawn once by the
reference's ``init_vision_params`` and pixels from the reference's
``bytes_to_pixels``. Tolerances: pixels, content hashes and wire items
bit-equal; the tower's output in float32 within atol 1e-5 of the reference's
(summation order only), on ``tiny-vl`` and on a wider case (patch 8, image
64, hidden 128, 4 heads, 16 media tokens, so 64 patches pool by 4). A control
with the exact GELU must miss that bound: the reference's ``jax.nn.gelu`` is
the tanh approximation.
"""

import base64
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from llmd_tpu.disagg import encode as je
from llmd_tpu.models import get_model_config as jax_model_config
from llmd_tpu.models import vision as jv
from llmd_tpu_torch.disagg import encode as te
from llmd_tpu_torch.models import get_model_config
from llmd_tpu_torch.models import transformer as tt
from llmd_tpu_torch.models import vision as tv

ATOL = 1e-5
WIDE = dict(vision_patch=8, vision_image_size=64, vision_hidden=128, vision_heads=4,
            mm_tokens=16)
CASES = {"tiny-vl": {}, "wide": WIDE}
PAYLOADS = [b"", b"x", b"image-A", bytes(range(256)) * 3]


@functools.cache
def _case(name: str):
    over = {"dtype": "float32", **CASES[name]}
    jcfg = dataclasses.replace(jax_model_config("tiny-vl"), **over)
    tcfg = dataclasses.replace(get_model_config("tiny-vl"), **over)
    jp = jv.init_vision_params(jcfg, jax.random.PRNGKey(3))
    return jcfg, tcfg, jp, {k: np.asarray(v) for k, v in jp.items()}


def _pixels(jcfg, n: int = 3) -> np.ndarray:
    return np.stack([jv.bytes_to_pixels(jcfg, b"pixels-%d" % i) for i in range(n)])


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("payload", PAYLOADS, ids=range(len(PAYLOADS)))
def test_pixels_and_content_hash_bit_equal(name, payload):
    jcfg, tcfg, _, _ = _case(name)
    got = tv.bytes_to_pixels(tcfg, payload)
    ref = jv.bytes_to_pixels(jcfg, payload)
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    assert np.array_equal(got, ref)
    assert tv.mm_content_hash(payload) == jv.mm_content_hash(payload)


@pytest.mark.parametrize("name", list(CASES))
def test_encode_images_matches_reference(name):
    jcfg, tcfg, jp, npp = _case(name)
    px = _pixels(jcfg)
    ref = np.asarray(jv.encode_images(jcfg, jp, px))
    got = tv.encode_images(tcfg, tv.vision_params_from_numpy(tcfg, npp), torch.from_numpy(px))
    assert got.shape == (3, tcfg.mm_tokens, tcfg.hidden_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", list(CASES))
def test_exact_gelu_control_misses_the_bound(name, monkeypatch):
    """The same tower with ``F.gelu``'s exact form lands outside ATOL: the
    bound tells the reference's tanh GELU from the exact one."""
    jcfg, tcfg, jp, npp = _case(name)
    px = _pixels(jcfg)
    ref = np.asarray(jv.encode_images(jcfg, jp, px))
    gelu = tv.F.gelu
    monkeypatch.setattr(tv.F, "gelu", lambda x, approximate: gelu(x, approximate="none"))
    exact = tv.encode_images(tcfg, tv.vision_params_from_numpy(tcfg, npp),
                             torch.from_numpy(px))
    assert np.abs(exact.numpy() - ref).max() > ATOL


def test_bf16_tower_matches_reference_in_rounding():
    """tiny-vl in its registry dtype (bfloat16) on the reference's bf16
    params: within 5% of the output's max abs (bf16 products and casts at
    every step of both)."""
    jcfg = jax_model_config("tiny-vl")
    tcfg = get_model_config("tiny-vl")
    jp = jv.init_vision_params(jcfg, jax.random.PRNGKey(3))
    px = _pixels(jcfg)
    ref = np.asarray(jv.encode_images(jcfg, jp, px), np.float32)
    got = tv.encode_images(tcfg, tv.vision_params_from_numpy(
        tcfg, {k: np.asarray(v, np.float32) for k, v in jp.items()}), torch.from_numpy(px))
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - ref).max() <= 0.05 * np.abs(ref).max()


def test_vision_params_shapes_and_refusals():
    jcfg, tcfg, jp, npp = _case("wide")
    assert tv.vision_param_shapes(tcfg) == {k: tuple(v.shape) for k, v in jp.items()}
    drawn = tv.init_vision_params(tcfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in drawn.items()} == tv.vision_param_shapes(tcfg)
    assert torch.equal(drawn["v_norm1"], torch.ones_like(drawn["v_norm1"]))
    with pytest.raises(ValueError, match="vision params"):
        tv.vision_params_from_numpy(tcfg, {k: v for k, v in npp.items() if k != "v_pos"})
    with pytest.raises(ValueError, match="v_pos"):
        tv.vision_params_from_numpy(tcfg, {**npp, "v_pos": npp["v_pos"][:-1]})
    with pytest.raises(NotImplementedError, match="do not pool"):
        tt.check_supported(dataclasses.replace(tcfg, mm_tokens=7))


def test_vision_flops_of_the_clip_l336_tower():
    """The tower's operation count at CLIP ViT-L/14-336 widths (the full-width
    config the card runs): ~0.38 TFLOP an image, ~305 M parameters."""
    cfg = dataclasses.replace(get_model_config("llama-1b"), mm_tokens=576,
                              mm_placeholder_id=32767, vision_patch=14, vision_image_size=336,
                              vision_layers=24, vision_hidden=1024, vision_heads=16)
    assert tv.n_patches(cfg) == 576
    assert 0.37e12 < tv.vision_flops(cfg) < 0.39e12
    n = sum(int(np.prod(s)) for s in tv.vision_param_shapes(cfg).values())
    assert 300e6 < n < 310e6


def test_runner_matches_reference_runner_on_its_params():
    """The port's ``VisionRunner`` given the reference runner's own params
    (float32 tiny-vl) encodes within ATOL of it, with the same hashes."""
    jcfg, tcfg, _, _ = _case("tiny-vl")
    ref_runner = je.VisionRunner(jcfg)
    ours = te.VisionRunner(tcfg, device="cpu",
                           params={k: np.asarray(v) for k, v in ref_runner.params.items()})
    ref, got = [], []
    for payloads in ([b"one", b"two"], [b"one"]):  # the second call hits the LRU
        ref += ref_runner.encode(payloads)
        got += ours.encode(payloads)
    for (rh, re_), (gh, ge) in zip(ref, got):
        assert rh == gh
        np.testing.assert_allclose(ge, re_, atol=ATOL, rtol=0)
    assert ours.stats == ref_runner.stats == {"encoded_items": 2, "cache_hits": 1}


def test_runner_lru_hits_and_determinism():
    tcfg = get_model_config("tiny-vl")
    r1 = te.VisionRunner(tcfg, device="cpu", cache_items=2)
    r2 = te.VisionRunner(tcfg, device="cpu")
    [(h1, e1)] = r1.encode([b"same"])
    [(h2, e2)] = r2.encode([b"same"])
    assert h1 == h2 == tv.mm_content_hash(b"same")
    np.testing.assert_array_equal(e1, e2)  # interchangeable workers
    assert e1.shape == (tcfg.mm_tokens, tcfg.hidden_size) and e1.dtype == np.float32
    r1.encode([b"same", b"other"])
    assert r1.stats == {"encoded_items": 2, "cache_hits": 1}
    r1.encode([b"third"])  # the LRU holds 2: "same" is the oldest and goes
    r1.encode([b"same"])
    assert r1.stats == {"encoded_items": 4, "cache_hits": 1}
    with pytest.raises(ValueError, match="no vision tower"):
        te.VisionRunner(get_model_config("tiny"), device="cpu")


def test_wire_round_trip_byte_equal():
    tcfg = get_model_config("tiny-vl")
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((tcfg.mm_tokens, tcfg.hidden_size)).astype(np.float32)
    h = bytes(range(32))
    wire = te.mm_item_to_wire(h, emb)
    assert wire == je.mm_item_to_wire(h, emb)
    rh, remb = te.mm_item_from_wire(wire, tcfg.hidden_size)
    jh, jemb = je.mm_item_from_wire(wire, tcfg.hidden_size)
    assert rh == jh == h
    assert remb.tobytes() == jemb.tobytes() == emb.tobytes()


def test_media_helpers_equal_reference():
    from llmd_tpu.core import request as jr
    from llmd_tpu_torch.core import request as tr

    data = "data:image/x-raw;base64," + base64.b64encode(b"xyz").decode()
    parts = [{"type": "image_url", "image_url": {"url": data}},
             {"type": "input_audio", "input_audio": {"data": data}},
             {"type": "image_url", "image_url": {"url": "http://remote/x.png"}},
             {"type": "text", "text": "hi"}, "bare", {"type": "video_url"}]
    for part in parts:
        assert te.is_media_part(part) == je.is_media_part(part)
        assert tr.part_is_inline_media(part) == jr.part_is_inline_media(part)
        if isinstance(part, dict):
            assert tr._mm_hash(part) == jr._mm_hash(part)
            assert te.part_identity(part) == je.part_identity(part)
            assert te.media_bytes_from_part(part) == je.media_bytes_from_part(part)
    body = {"messages": [{"role": "user", "content": parts},
                         {"role": "user", "content": "plain"}]}
    assert list(te.iter_media_parts(body)) == list(je.iter_media_parts(body))
    assert tr.mm_hashes_from_messages(body["messages"]) == \
        jr.mm_hashes_from_messages(body["messages"])
    assert tr.flatten_messages(body["messages"]) == jr.flatten_messages(body["messages"])
