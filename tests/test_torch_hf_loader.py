"""The port's HF checkpoint loader (``llmd_tpu_torch/models/hf_loader.py``, with
its own safetensors reader) and checkpoint writer
(``llmd_tpu_torch/testing/checkpoints.py``) against the reference's, on the CPU.

Checkpoints come from the reference's ``make_hf_checkpoint`` (real
``save_pretrained`` files of transformers models): Llama with tied and untied
embeddings, sharded, float32 and bfloat16, Qwen2 (q/k/v biases) and Qwen3
(an explicit ``head_dim`` and per-head q/k RMSNorm). ``config_from_hf``
agrees field by field, every loaded leaf is bit-equal to the reference
loader's, and greedy tokens and logits of the two engines on the loaded
weights (float32) are equal. Files written by the port's writer load
bit-equal through the reference loader, and Qwen2 / Qwen3 checkpoints of
unit-scale random weights with nonzero biases / non-unit q/k norms written by
it serve the same greedy tokens through both engines.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmd_tpu.core.request import SamplingParams as JaxSamplingParams
from llmd_tpu.engine import EngineConfig as JaxEngineConfig
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.models import hf_loader as jh
from llmd_tpu.models import transformer as jt
from llmd_tpu.testing.checkpoints import make_hf_checkpoint
from llmd_tpu_torch.core.request import SamplingParams
from llmd_tpu_torch.engine import EngineConfig, LLMEngine
from llmd_tpu_torch.models import hf_loader as th
from llmd_tpu_torch.models import resolve_model
from llmd_tpu_torch.models import safetensors_io as sio
from llmd_tpu_torch.models import transformer as tt
from llmd_tpu_torch.testing.checkpoints import write_hf_checkpoint

CASES = {
    "llama-tied": ("llama", dict(tie_embeddings=True)),
    "llama-untied-sharded": ("llama", dict(tie_embeddings=False, max_shard_size="50KB")),
    "llama-bf16": ("llama", dict(torch_dtype="bfloat16")),
    "qwen2-bias": ("qwen2", dict()),
    "qwen3-qknorm": ("qwen3", dict(head_dim=32)),
}
ENGINE = dict(page_size=8, num_pages=64, max_model_len=256, max_batch_size=4,
              prefill_chunk=32, decode_steps=4)
PROMPTS = [list(range(5, 40)), list(range(100, 121)), list(range(200, 260))]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf")
    return {name: make_hf_checkpoint(str(root / name), fam, with_tokenizer=False, **kw)
            for name, (fam, kw) in CASES.items()}


def _np(x):
    return np.asarray(x, np.float32)


def _assert_bit_equal(jp: dict, tp: dict) -> None:
    assert set(jp) == set(tp)
    for k in jp:
        a, b = _np(jp[k]), tp[k].float().numpy()
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def _greedy(jcfg, jp, tcfg, tp) -> tuple[dict, dict]:
    je = JaxEngine(jcfg, JaxEngineConfig(**ENGINE, attn_impl="reference"), params=jp)
    te = LLMEngine(tcfg, EngineConfig(**ENGINE), params=tp, device="cpu")
    return (je.generate(PROMPTS, JaxSamplingParams(max_tokens=8, temperature=0.0)),
            te.generate(PROMPTS, SamplingParams(max_tokens=8, temperature=0.0)))


def _logits(jcfg, jp, tcfg, tp) -> tuple[np.ndarray, np.ndarray]:
    """Valid rows' logits of a padded [B, T] batch through the reference's
    ``forward`` and the port's."""
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    pos = np.array([np.arange(12), [0, 1, 2, 3, 4, 5, 6, 7, -1, -1, -1, -1]], np.int32)
    pts, lens = np.array([[0, 1], [2, 3]], np.int32), np.array([12, 8], np.int32)
    valid = pos >= 0
    lj, *_ = jt.forward(jcfg, jp, jt.init_cache(jcfg, 4, 8),
                        *map(jnp.asarray, (toks, pos, pts, lens)))
    lt, _ = tt.forward(tcfg, tp, tt.init_cache(tcfg, 4, 8),
                       *map(torch.from_numpy, (toks, pos, pts, lens)))
    return _np(lj)[valid], lt.numpy()[valid]


@pytest.mark.parametrize("case", sorted(CASES))
def test_config_and_params_match_reference_loader(checkpoints, case):
    path = checkpoints[case]
    for dtype in ("float32", "bfloat16"):
        jcfg, tcfg = jh.config_from_hf(path, dtype=dtype), th.config_from_hf(path, dtype=dtype)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        tp = th.load_params(path, tcfg)
        assert all(v.dtype == tcfg.torch_dtype for v in tp.values())
        _assert_bit_equal(jh.load_params(path, jcfg), tp)
    assert tcfg.qk_norm == (case == "qwen3-qknorm")
    assert tcfg.attn_bias == (case == "qwen2-bias")
    assert th.is_hf_checkpoint(path) and not th.is_hf_checkpoint(os.path.dirname(path))


@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_tokens_match_reference_engine(checkpoints, case):
    """Greedy tokens of both engines, and (since the checkpoints' small HF
    init makes greedy streams nearly constant) the logits of a padded
    [B, T] batch through both ``forward``s: max abs <= 1e-4, same argmax."""
    path = checkpoints[case]
    jcfg, jp = jh.load_model(path, dtype="float32")
    tcfg, tp = resolve_model(path, dtype="float32")
    ref, got = _greedy(jcfg, jp, tcfg, tp)
    assert got == ref
    lj, lt = _logits(jcfg, jp, tcfg, tp)
    assert np.abs(lj - lt).max() <= 1e-4
    np.testing.assert_array_equal(lj.argmax(-1), lt.argmax(-1))


@pytest.mark.parametrize("case", sorted(CASES))
def test_written_checkpoint_loads_bit_equal_in_reference_loader(checkpoints, tmp_path, case):
    """The port's writer is the loader's inverse: what it writes (single
    file, or shards with an index) the reference loader reads back
    bit-equal, in the stored dtype."""
    tcfg, tp = th.load_model(checkpoints[case], dtype="bfloat16")
    out = write_hf_checkpoint(str(tmp_path / "w"), tcfg, tp,
                              max_shard_bytes=60_000 if "sharded" in case else None)
    assert os.path.isfile(os.path.join(
        out, "model.safetensors.index.json" if "sharded" in case else "model.safetensors"))
    jcfg = jh.config_from_hf(out, dtype="bfloat16")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(
        dataclasses.replace(tcfg, name=jcfg.name))
    _assert_bit_equal(jh.load_params(out, jcfg), tp)
    _assert_bit_equal(jh.load_params(out, jcfg), th.load_params(out))


@pytest.mark.parametrize("case", ["qwen2-bias", "qwen3-qknorm"])
def test_written_checkpoint_serves_like_the_reference(checkpoints, tmp_path, case):
    """The port's random init at the checkpoint's config (unit-scale logits,
    so greedy streams vary), with nonzero q/k/v/o biases on Qwen2 (the HF
    init leaves them at zero) and non-unit q/k norms on Qwen3, written by the
    port's writer in float32: equal greedy tokens and logits (to 1e-4, same
    argmax) through both engines, and the biases / norms change the
    logits."""
    tcfg = th.config_from_hf(checkpoints[case], dtype="float32")
    g = torch.Generator().manual_seed(3)
    tp = tt.init_params(tcfg, g)
    extra = ("bq", "bk", "bv", "bo") if tcfg.attn_bias else ("q_norm", "k_norm")
    for k in extra:
        tp[k] = tp[k] + torch.randn(tp[k].shape, generator=g) * 0.5
    out = write_hf_checkpoint(str(tmp_path / "b"), tcfg, tp)
    jcfg, jp = jh.load_model(out, dtype="float32")
    tcfg2, tp2 = th.load_model(out, dtype="float32")
    _assert_bit_equal(jp, tp2)
    ref, got = _greedy(jcfg, jp, tcfg2, tp2)
    assert got == ref
    lj, lt = _logits(jcfg, jp, tcfg2, tp2)
    assert np.abs(lj - lt).max() <= 1e-4
    np.testing.assert_array_equal(lj.argmax(-1), lt.argmax(-1))
    plain = dict(tp2, **{k: torch.zeros_like(tp2[k]) if k[0] == "b" else torch.ones_like(tp2[k])
                         for k in extra})
    _, lp = _logits(jcfg, jp, tcfg2, plain)
    assert np.abs(lp - lt).max() > 1e-2


def test_safetensors_reader_and_writer_agree_with_the_library(tmp_path):
    """bf16, f16 and f32 tensors written by the port read back bit-equal by
    the ``safetensors`` package, and the library's files by the port."""
    from safetensors import safe_open
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(0)
    ts = {"a": torch.randn(3, 5, generator=g).bfloat16(),
          "b": torch.randn(7, generator=g).half(), "c": torch.randn(2, 2, 2, generator=g)}
    mine = str(tmp_path / "mine.safetensors")
    sio.write_file(mine, ts.items())
    with safe_open(mine, framework="pt") as f:
        for k, v in ts.items():
            assert torch.equal(f.get_tensor(k), v) and f.get_tensor(k).dtype == v.dtype
    theirs = str(tmp_path / "theirs.safetensors")
    save_file(ts, theirs)
    r = sio.SafetensorsFile(theirs)
    assert sorted(r.keys()) == sorted(ts)
    for k, v in ts.items():
        assert torch.equal(r.get(k), v) and r.get(k).dtype == v.dtype
    with open(mine, "rb") as f:  # the header is padded to 8 bytes
        assert int.from_bytes(f.read(8), "little") % 8 == 0
    with pytest.raises(ValueError, match="dtype"):
        sio.write_file(str(tmp_path / "x"), [("i", torch.zeros(2, dtype=torch.int64))])


def test_resolve_model_and_refusals(checkpoints, tmp_path):
    cfg, params = resolve_model("tiny")
    assert cfg.name == "tiny" and params is None
    cfg, params = resolve_model(checkpoints["llama-tied"])
    assert cfg.dtype == "bfloat16" and params["embed"].dtype == torch.bfloat16
    bad = tmp_path / "bad"
    bad.mkdir()
    cfg_json = json.load(open(os.path.join(checkpoints["llama-tied"], "config.json")))
    for extra, match in ((dict(architectures=["GPT2LMHeadModel"]), "architecture"),
                         (dict(rope_scaling={"rope_type": "llama3"}), "rope_scaling"),
                         (dict(sliding_window=64), "sliding_window")):
        (bad / "config.json").write_text(json.dumps({**cfg_json, **extra}))
        with pytest.raises(ValueError, match=match):
            th.config_from_hf(str(bad))
    (bad / "config.json").write_text(json.dumps(cfg_json))
    with pytest.raises(FileNotFoundError):
        th.load_params(str(bad))
