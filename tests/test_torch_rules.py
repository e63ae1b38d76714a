"""Rules of the PyTorch port that no parity test would catch.

- No module of ``src/repro_torch/``, and not ``chip_smoke.py``, imports
  ``jax``, ``jaxlib`` or anything of the JAX package ``repro``.
- Entry points run on the card by default and raise without CUDA unless the
  caller passes ``device="cpu"``.
- Kernel wrappers run the plain version only for CPU tensors: for a CUDA
  tensor whose kernel cannot be built they raise, and count no launch.
"""
import ast
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data import loader
from repro_torch.kernels import _build, ops
from repro_torch.kernels import block_grad_norm as bgn
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import masked_adamw as madamw
from repro_torch.kernels import paged_decode_attention as pda
from repro_torch.kernels import rmsnorm as rn
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import lm
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.train.step import init_train_state
from repro_torch.train.trainer import Trainer

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            roots.add(node.args[0].value.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_nothing_of_jax(path):
    assert path.exists(), path
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_import_scan_sees_forbidden_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom repro.serve import x\n"
                 "import importlib\nimportlib.import_module('jaxlib.xla')\n")
    assert _imported_roots(f) >= {"jax", "repro", "jaxlib"}


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _cfg():
    return get_smoke_config("qwen2.5-0.5b")


def _tcfg(**kw):
    return TrainConfig(model=_cfg(), seq_len=48, global_batch=2, steps=2,
                       **kw)


@pytest.mark.parametrize("call", [
    lambda: lm.init(_cfg()),
    lambda: lm.init(_cfg(), device="cuda"),
    lambda: lm.init_cache(_cfg(), 2, 16),
    lambda: lm.init_paged_cache(_cfg(), 2, 16, 4, 8),
    lambda: convert.params_from_numpy({}, _cfg()),
    lambda: ServeEngine(_cfg(), {}, ServeConfig(max_len=16, num_slots=2)),
    lambda: launch_serve.main(["--arch", "qwen2.5-0.5b", "--smoke"]),
    lambda: convert.train_state_from_numpy({"opt": {}}, _cfg()),
    lambda: init_train_state(_cfg()),
    lambda: init_train_state(_cfg(), moment_residency="banked"),
    lambda: Trainer(_tcfg()),
    lambda: launch_train.main(["--arch", "qwen2.5-0.5b", "--smoke",
                               "--steps", "2"]),
    lambda: Trainer(_tcfg(), data_source=loader.make_source(
        "packed_math", seq_len=48, global_batch=2)),
    lambda: launch_train.main(["--arch", "qwen2.5-0.5b", "--smoke",
                               "--steps", "2", "--pack"]),
], ids=["init", "init-cuda", "init_cache", "init_paged_cache", "convert",
        "engine", "launcher", "convert-train-state", "init_train_state",
        "init_train_state-banked", "trainer", "train-launcher",
        "trainer-packed", "train-launcher-packed"])
def test_entry_points_need_cuda_by_default(no_cuda, call):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def test_entry_points_run_on_cpu_when_asked(no_cuda, capsys):
    params = lm.init(_cfg(), torch.Generator().manual_seed(0), device="cpu")
    eng = ServeEngine(_cfg(), params, ServeConfig(max_len=16, num_slots=2),
                      device="cpu")
    out = eng.generate({"tokens": np.ones((2, 4), np.int32)},
                       max_new_tokens=3)
    assert out.shape == (2, 3)
    with pytest.raises(ValueError, match="params live on"):
        ServeEngine(_cfg(), {"w": torch.zeros(1, device="meta")},
                    ServeConfig(max_len=16, num_slots=2), device="cpu")
    assert launch_serve.main(["--arch", "qwen2.5-0.5b", "--smoke",
                              "--device", "cpu", "--new-tokens", "4"]) == 0
    assert "steady state" in capsys.readouterr().out
    state = init_train_state(_cfg(), device="cpu")
    assert state["params"]["embed"]["tok"].device.type == "cpu"
    log = Trainer(_tcfg(log_every=1), device="cpu").train()
    assert len(log.losses) == 2 and np.isfinite(log.losses).all()
    assert launch_train.main(["--arch", "qwen2.5-0.5b", "--smoke",
                              "--device", "cpu", "--steps", "4",
                              "--seq-len", "48", "--global-batch", "2"]) == 0
    out = capsys.readouterr().out
    assert "final loss" in out and "device: cpu" in out


@pytest.mark.parametrize("call, item", [
    (lambda: Trainer(_tcfg(), method="lora", device="cpu"), "item 4"),
    (lambda: Trainer(_tcfg(checkpoint_dir="ckpt"), device="cpu"), "item 3"),
    (lambda: Trainer(_tcfg(eval_every=1), device="cpu"), "item 5"),
    (lambda: Trainer(_tcfg(), prefetch_depth=2, device="cpu"), "item 8"),
    (lambda: Trainer(_tcfg(), mesh=object(), device="cpu"), "item 11"),
    (lambda: launch_train.main(["--arch", "qwen2.5-0.5b", "--smoke",
                                "--device", "cpu", "--data", "jsonl"]),
     "item 8"),
    (lambda: launch_train.main(["--arch", "qwen2.5-0.5b", "--smoke",
                                "--device", "cpu", "--trace", "t.json"]),
     "item 10"),
    (lambda: launch_train.main(["--arch", "qwen2.5-0.5b", "--smoke",
                                "--device", "cpu", "--moment-residency",
                                "banked", "--offload", "zero1"]), "item 11"),
], ids=["lora", "checkpoint", "eval", "prefetch", "mesh", "jsonl", "trace",
        "banked-zero1"])
def test_training_features_not_ported_raise(call, item):
    with pytest.raises(NotImplementedError, match=item):
        call()


@pytest.mark.parametrize("offload", ["host", "none"])
def test_banked_launcher_runs_on_cpu(offload, capsys):
    assert launch_train.main(["--arch", "qwen2.5-0.5b", "--smoke",
                              "--device", "cpu", "--moment-residency",
                              "banked", "--offload", offload, "--async-swap",
                              "on", "--steps", "4", "--seq-len", "48",
                              "--global-batch", "2"]) == 0
    out = capsys.readouterr().out
    assert "final loss" in out and "resident moment bytes" in out
    assert '"dispatches": 4' in out


@pytest.mark.parametrize("data", ["synthetic_math", "jsonl_sft"])
def test_packed_launcher_runs_on_cpu(data, tmp_path, capsys):
    """``--pack`` trains on packed records (the synthetic corpus, or a
    prompt/completion jsonl) and prints tokens/s beside the non-pad tokens
    and records a step."""
    path = tmp_path / "c.jsonl"
    path.write_text("\n".join(json.dumps({"prompt": f"{i} + {i} =",
                                          "completion": str(2 * i)})
                              for i in range(40)))
    assert launch_train.main(["--arch", "qwen2.5-0.5b", "--smoke",
                              "--device", "cpu", "--pack", "--data", data,
                              "--data-path", str(path), "--steps", "4",
                              "--seq-len", "96", "--global-batch", "2"]) == 0
    out = capsys.readouterr().out
    assert "final loss" in out and "records a step" in out
    assert "non-pad tokens/s" in out and "nan" not in out.split(
        "tokens/s:")[1].split("\n")[0]


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: stands in for a card so the
    wrappers' CUDA branch runs here."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake(t):
    return torch.Tensor._make_subclass(_FakeCuda, t)


@pytest.fixture
def missing_builds(monkeypatch, tmp_path):
    """Neither kernel can be built: no nvcc, no triton."""
    def no_nvcc():
        raise _build.KernelBuildFailure("nvcc not found (stub)")
    monkeypatch.setattr(_build, "nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(pda, "_fn", None)
    monkeypatch.setattr(fa, "_fn", None)
    for mod in (rn, bgn, madamw):
        monkeypatch.setattr(mod, "_compiled", None)
    monkeypatch.setitem(sys.modules, "triton", None)


def test_wrappers_raise_for_cuda_tensors_without_a_build(missing_builds):
    before = dict(ops.LAUNCHES)
    q = _fake(torch.zeros(2, 1, 16, 64))
    pool = _fake(torch.zeros(8, 4, 2, 64))
    tbl = _fake(torch.zeros(2, 4, dtype=torch.int32))
    vl = _fake(torch.ones(2, dtype=torch.int32))
    hm = _fake(torch.zeros(16, dtype=torch.int32))
    with pytest.raises(_build.KernelBuildFailure, match="nvcc"):
        ops.paged_decode_attention(q, pool, pool, tbl, vl, hm)
    with pytest.raises(_build.KernelBuildFailure, match="triton"):
        ops.rmsnorm(_fake(torch.zeros(3, 8)), _fake(torch.ones(8)))
    x = _fake(torch.zeros(3, 8))
    with pytest.raises(_build.KernelBuildFailure, match="triton"):
        ops.rmsnorm_bwd(x, x, _fake(torch.ones(8)))
    with pytest.raises(_build.KernelBuildFailure, match="triton"):
        ops.block_grad_sq_norms(x)
    row = _fake(torch.ones(3))
    with pytest.raises(_build.KernelBuildFailure, match="triton"):
        ops.masked_adamw(x, x, x, x, row, row, 1e-3, 0.9, 0.999, 1e-8, 0.0)
    assert ops.LAUNCHES == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    q = _fake(torch.zeros(2, 1, 16, 32))   # head dim 32: kernel takes 64
    pool = _fake(torch.zeros(8, 4, 2, 32))
    i32 = [_fake(torch.zeros(2, 4, dtype=torch.int32)),
           _fake(torch.ones(2, dtype=torch.int32)),
           _fake(torch.zeros(16, dtype=torch.int32))]
    with pytest.raises(ValueError, match="head dim"):
        ops.paged_decode_attention(q, pool, pool, *i32)
    q32 = _fake(torch.zeros(2, 1, 32, 64))   # 32 q heads: kernel takes 16
    pool64 = _fake(torch.zeros(8, 4, 2, 64))
    with pytest.raises(ValueError, match="at most 16 q heads"):
        ops.paged_decode_attention(q32, pool64, pool64, *i32[:2],
                                   _fake(torch.zeros(32, dtype=torch.int32)))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.rmsnorm(_fake(torch.zeros(3, 8, dtype=torch.float16)),
                    _fake(torch.ones(8, dtype=torch.float16)))
    with pytest.raises(ValueError, match="different devices"):
        ops.rmsnorm(_fake(torch.zeros(3, 8)), torch.ones(8))
    with pytest.raises(ValueError, match="not supported"):
        ops.rmsnorm(torch.zeros(3, 8, device="meta"),
                    torch.ones(8, device="meta"))
    f16 = _fake(torch.zeros(3, 8, dtype=torch.float16))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.block_grad_sq_norms(f16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.rmsnorm_bwd(f16, f16, _fake(torch.ones(8)))
    x, row = _fake(torch.zeros(3, 8)), _fake(torch.ones(3))
    with pytest.raises(ValueError, match="m must be float32"):
        ops.masked_adamw(x, x, _fake(torch.zeros(3, 8, dtype=torch.bfloat16)),
                         x, row, row, 1e-3, 0.9, 0.999, 1e-8, 0.0)
    with pytest.raises(ValueError, match="sel and counts must be"):
        ops.masked_adamw(x, x, x, x, _fake(torch.ones(4)), row, 1e-3, 0.9,
                         0.999, 1e-8, 0.0)


def test_banked_wrapper_raises_and_rejects(missing_builds):
    """Row 9 on CUDA tensors: no build raises and counts nothing; what the
    kernel does not take is refused."""
    before = dict(ops.LAUNCHES)
    p, bank = _fake(torch.zeros(4, 8)), _fake(torch.zeros(2, 8))
    slots = _fake(torch.tensor([1, 4], dtype=torch.int32))
    row = _fake(torch.ones(2))
    args = (1e-3, 0.9, 0.999, 1e-8, 0.0)
    with pytest.raises(_build.KernelBuildFailure, match="triton"):
        ops.banked_masked_adamw(p, p, bank, bank, slots, row, row, *args)
    assert ops.LAUNCHES == before
    with pytest.raises(ValueError, match="slots must be int32"):
        ops.banked_masked_adamw(p, p, bank, bank, _fake(slots.long()), row,
                                row, *args)
    with pytest.raises(ValueError, match="same trailing shape"):
        ops.banked_masked_adamw(p, p, _fake(torch.zeros(2, 9)), bank, slots,
                                row, row, *args)
    with pytest.raises(ValueError, match=r"\[cap=2\]"):
        ops.banked_masked_adamw(p, p, bank, bank, slots,
                                _fake(torch.ones(3)), row, *args)


def test_flash_wrapper_raises_and_rejects(missing_builds):
    """Rows 4-6 on CUDA tensors: no build raises and counts nothing; fp16,
    a head dim other than 64 or 128, a softcap and ids that are not int32
    are refused by name."""
    before = dict(ops.LAUNCHES)
    q, kv = _fake(torch.zeros(2, 8, 4, 64)), _fake(torch.zeros(2, 8, 2, 64))
    hm = _fake(torch.tensor([0, 0, 1, 1], dtype=torch.int32))
    seg = _fake(torch.ones(2, 8, dtype=torch.int32))
    with pytest.raises(_build.KernelBuildFailure, match="nvcc"):
        ops.flash_attention(q, kv, kv, hm, segment_ids=seg)
    with pytest.raises(_build.KernelBuildFailure, match="nvcc"):
        ops.flash_attention_bwd(q, kv, kv, q, _fake(torch.zeros(2, 4, 8)), q,
                                hm)
    assert ops.LAUNCHES == before
    f16 = _fake(torch.zeros(2, 8, 4, 64, dtype=torch.float16))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.flash_attention(f16, f16[:, :, :2].contiguous(),
                            f16[:, :, :2].contiguous(), hm)
    q32, kv32 = _fake(torch.zeros(2, 8, 4, 32)), _fake(torch.zeros(2, 8, 2,
                                                                  32))
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q32, kv32, kv32, hm)
    with pytest.raises(ValueError, match="softcap"):
        ops.flash_attention(q, kv, kv, hm, softcap=30.0)
    with pytest.raises(ValueError, match="segment_ids must be int32"):
        ops.flash_attention(q, kv, kv, hm, segment_ids=_fake(seg.long()))
    with pytest.raises(ValueError, match="hmap must be int32"):
        ops.flash_attention(q, kv, kv, _fake(hm.long()))
