"""The port stands alone: it imports no JAX and nothing of ``mvuld_tpu``,
and needs none of the host extras (PIL, yaml, pandas, cv2, tokenizers,
matplotlib, sklearn) to import. ``chip_smoke.py`` refuses to run without a
CUDA device, and its ``main`` drives every phase."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN_ROOTS = {"jax", "jaxlib", "flax", "orbax", "optax"}


def _sources():
    files = sorted((ROOT / "mvuld_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_and_no_jax_package(path):
    for mod in _imported_modules(path):
        root = mod.split(".")[0]
        assert root not in FORBIDDEN_ROOTS, f"{path}: imports {mod}"
        assert root != "mvuld_tpu", f"{path}: imports {mod}"


def _run(code, cwd=ROOT, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT), **(env_extra or {}))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


def test_package_imports_with_jax_and_host_extras_blocked():
    code = """
import pkgutil, sys
for name in ("jax", "jaxlib", "flax", "orbax", "PIL", "yaml", "pandas",
             "tokenizers", "matplotlib", "cv2", "sklearn"):
    sys.modules[name] = None
import mvuld_tpu_torch
import mvuld_tpu_torch.train.predict
import mvuld_tpu_torch.train.train_swin
import mvuld_tpu_torch.tools.blockbench
import mvuld_tpu_torch.models.swin_convert
import mvuld_tpu_torch.models.unixcoder
import mvuld_tpu_torch.tools.storage
import mvuld_tpu_torch.train.precompute
import mvuld_tpu_torch.train.train_text
import mvuld_tpu_torch.train.train_fusion
import mvuld_tpu_torch.train.pipeline
import mvuld_tpu_torch.train.train_east
for name in ("gt", "detect", "lanms_native", "icdar_eval", "recognize",
             "east"):
    __import__("mvuld_tpu_torch.ocr." + name)
import mvuld_tpu_torch.models.baselines
import mvuld_tpu_torch.train.train_baseline
for name in ("embeddings", "patch_eval", "eval_patches", "process_dataset",
             "gitdiff", "mutate"):
    __import__("mvuld_tpu_torch.tools." + name)
for name in ("utils.oom", "utils.torch_convert", "models.fusion_convert",
             "models.swin_v1", "models.moe", "models.swin_variants",
             "data.zip_folder", "tools.convert_checkpoint",
             "tools.joern_json", "tools.make_images", "tools.results_table",
             "tools.traceparse", "tools.hardprobe", "tools.fontbench",
             "parallel", "parallel.collectives", "parallel.distributed",
             "parallel.mesh", "parallel.pipeline"):
    __import__("mvuld_tpu_torch." + name)
from mvuld_tpu_torch.models.unixcoder import (UniXcoderLM,
                                              beam_search_generate)
from mvuld_tpu_torch.models.moe import expert_parallel
from mvuld_tpu_torch.ops.window_attention import (
    window_attention_flat_sharded)
for m in pkgutil.walk_packages(mvuld_tpu_torch.__path__, "mvuld_tpu_torch."):
    __import__(m.name)
bad = [m for m in sys.modules if m == "mvuld_tpu" or m.startswith("mvuld_tpu.")]
assert not bad, bad
print("imported", sum(m.startswith("mvuld_tpu_torch") for m in sys.modules))
"""
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert "imported" in r.stdout


def test_chip_smoke_fails_without_a_card():
    """No CUDA device: a non-zero exit and no result line."""
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       cwd=ROOT, capture_output=True, text=True, timeout=240,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=240, env=env)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


PHASES = ("serve_phase", "train_phase", "swin_phase", "fused_steps_phase",
          "blockbench_phase", "ops_phase", "staged_phase", "zoo_phase", "ocr_phase",
          "baselines_phase", "swin_family_phase", "causal_phase",
          "parallel_phase", "tools_phase")


@pytest.mark.parametrize("phase", PHASES)
def test_chip_smoke_main_drives_the_phase(phase):
    """Each phase is a function of the script that ``main`` calls."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    assert phase in funcs
    called = {c.func.id for c in ast.walk(funcs["main"])
              if isinstance(c, ast.Call) and isinstance(c.func, ast.Name)}
    assert phase in called


def test_cuda_device_without_a_card_raises(monkeypatch):
    import torch

    from mvuld_tpu_torch.train.predict import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_kernel_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises; the
    plain version is taken only for CPU tensors (meta tensors stand in for
    a device here)."""
    import torch

    from mvuld_tpu_torch.ops.fused_dense import dense_fwd, mlp_ln, mlp_ln_res
    from mvuld_tpu_torch.ops.window_attention import window_attention_flat
    m = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        window_attention_flat(torch.zeros(4, 16, 48, device=m),
                              torch.zeros(2, 16, 16, device=m),
                              torch.zeros(2, device=m))
    args = [torch.zeros(8, 16, device=m), torch.zeros(16, 128, device=m),
            torch.zeros(128, device=m), torch.zeros(128, 16, device=m)] + \
        [torch.zeros(16, device=m)] * 3
    for fn in (mlp_ln, mlp_ln_res):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(*args)
    with pytest.raises(ValueError, match="unsupported device"):
        dense_fwd(torch.zeros(8, 16, device=m), torch.zeros(16, 32, device=m),
                  torch.zeros(32, device=m))
    from mvuld_tpu_torch.ops import window_attention as wa
    q = torch.zeros(4, 2, 16, 32, device=m)
    qkv = torch.zeros(1, 8, 8, 3, 2, 32, device=m)
    bias, ls = torch.zeros(2, 16, 16, device=m), torch.ones(2, device=m)
    for call in (lambda: wa.window_attention_fwd(q, q, q, bias, ls),
                 lambda: wa.window_attention_bwd(q, q, q, bias, ls, q),
                 lambda: wa.window_attention(q, q, q, bias, ls),
                 lambda: wa.window_attention_map_fwd(qkv, bias, ls, 2),
                 lambda: wa.window_attention_map_bwd(qkv, bias, ls,
                                                     qkv[:, :, :, 0], 2),
                 lambda: wa.window_attention_map(qkv, bias, ls)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    assert not any(f.launches for f in (
        wa.window_attention_fwd, wa.window_attention_bwd,
        wa.window_attention_map_fwd, wa.window_attention_map_bwd))
    assert window_attention_flat.launches == 0
    assert mlp_ln.launches == 0 and mlp_ln_res.launches == 0
    assert dense_fwd.launches == 0


def test_trainer_starts_from_a_prebuilt_cache_without_host_extras(tmp_path):
    """The trainer CLI trains from an output directory that already holds
    ``cache/e2e.npz`` and ``tokenizer.json`` with jax, pandas, PIL, yaml
    and tokenizers blocked — the GPU machine has none of them."""
    from mvuld_tpu_torch.train.train_e2e import main

    opts = ["MODEL.UNIXCODER.LAYERS", "1", "MODEL.UNIXCODER.HIDDEN", "32",
            "MODEL.UNIXCODER.HEADS", "2", "MODEL.UNIXCODER.INTERMEDIATE",
            "64", "DATA.IMG_SIZE", "32", "DATA.FUNC_TOKENS", "32",
            "DATA.NODE_TOKENS", "8", "DATA.MAX_NODES", "16",
            "MODEL.SWINV2.EMBED_DIM", "16", "MODEL.SWINV2.DEPTHS", "[1,1]",
            "MODEL.SWINV2.NUM_HEADS", "[2,2]", "MODEL.SWINV2.WINDOW_SIZE",
            "4", "MODEL.SWINV2.PRETRAINED_WINDOW_SIZES", "[0,0]",
            "MODEL.MULTI.HIDDEN", "64", "MODEL.MULTI.NUM_RS_GCN", "1",
            "MODEL.MULTI.NUM_HIDDEN_FC", "1", "TRAIN.EPOCHS", "1",
            "PARALLEL.DTYPE", "float32"]
    out = str(tmp_path / "run")
    res = main(["--synthetic", "24", "--batch-size", "8", "--output", out,
                "--device", "cpu", "--cache-only", "--opts", *opts])
    assert res["cache_only"]
    code = f"""
import json, sys
for name in ("jax", "jaxlib", "flax", "orbax", "PIL", "yaml", "pandas",
             "tokenizers", "matplotlib"):
    sys.modules[name] = None
from mvuld_tpu_torch.train.train_e2e import main
res = main(["--batch-size", "8", "--output", {out!r}, "--device", "cpu",
            "--opts", *{opts!r}])
print(json.dumps(res["history"][0]["f1"]))
"""
    r = _run(code)
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(os.path.join(res["output"], "history.json"))
