"""Same-card A/B of the kernels' times between source trees.

Run from the root of a checkout, beside the ``chip_smoke.py`` it drives:

  python3 kernel_ab.py TREE [TREE ...]
      [--phase mlp dense attention layouts k2 optim]
      [--sass window_attention ...]
      [--sass-dir DIR]

For each TREE in the order given (parent, change, change, parent, say),
one fresh Python process with TREE as its working directory imports that
tree's ``chip_smoke.py`` and ``mvuld_tpu_torch``, builds every kernel source
of the tree and runs its checks of the chosen phases (each kernel against
its plain version, then timed on CUDA events):

  mlp        K3 and K3b at the bucket-16 and batch-64 SwinV2 shapes, K4 and
             K4b at the e2e model's shapes (``check_mlp`` / ``check_mlp_bwd``)
  dense      K6 and K6b at blockbench's shapes and a ragged row count, bf16
             and fp32 x (``check_dense``)
  attention  K1 and K2 at the bucket-16 shapes, K1, K2 and K5 at the
             batch-64 fine-tune's (``check_attention``)
  layouts    K7, K7b, K8 and K8b at every stage's bucket-16 shape
             (``check_layouts``)
  k2         K2 pass by pass at the bucket-16 (batch-16 training step)
             and batch-64 fine-tune shapes: the device ms of each of its
             kernels (``prep_operands``, the dq and dk/dv passes or the
             fused pass, ``attn_bwd_sums``, ``sum_partials``) per launch,
             mean of K2_REPS launches under ``torch.profiler``, as rows of
             kernel ``K2:<pass>``; and each shape's
             ``window_attention_flat_bwd.fused_launches`` per launch
             ("absent" in a tree without the counter)
  optim      clip + AdamW over the three training configurations'
             parameter lists: ``fused_adamw`` and ``sumsq`` against the
             path they replace, the two norm loops and the ``_foreach``
             chain (``optimizer_phase``; a tree without it fails)

and prints one line per kernel shape, one line per kernel and path with
the sum over its shapes of launches × ms (per bucket-16 forward, training
step or pass, as ``chip_smoke.py`` counts them), then one JSON line
``{"ab": [{"tree", "run", "kernel", "shape", "path", "per_fwd", "ms",
"plain_ms", "ok"}, ...]}``. Profiles are skipped. With ``--sass``, each tree also
prints a digest of every kernel's instructions in the named libraries
(``cuobjdump -sass``, addresses and encodings dropped), by mangled name
without its per-file prefix: equal digests mean the same machine code;
with ``--sass-dir`` it also writes the listings there, one file per run
and library (``<run>-<library>.sass``), to be compared with ``diff``.
Needs a CUDA card; compares only what runs in one call on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_CHILD = r"""
import hashlib, json, math, os, re, subprocess, sys
import torch
import chip_smoke as cs
from mvuld_tpu_torch.ops import _build

phases = sys.argv[1].split(",")
sass = [n for n in sys.argv[2].split(",") if n]
dump_to = sys.argv[3]
torch.backends.cuda.matmul.allow_tf32 = False
cs.profile_run = lambda *a, **k: None
_build.build_all(sorted(f[:-3] for f in os.listdir(_build.CSRC_DIR)
                        if f.endswith(".cu")))
tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
for name in sass:
    dump = subprocess.run([tool, "-sass", _build._lib_path(name)],
                          capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in dump.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "", m.group(1))
            funcs[cur] = []
        elif cur and re.match(r"\s*/\*[0-9a-f]{4}\*/", line):
            funcs[cur].append(line.split("*/", 1)[1].split("/*")[0].strip())
    for f, ins in sorted(funcs.items()):
        digest = hashlib.sha1("\n".join(ins).encode()).hexdigest()[:12]
        print(f"AB_SASS {name} {f} {len(ins)} {digest}", flush=True)
    if dump_to:
        with open(f"{dump_to}-{name}.sass", "w") as out:
            for f, ins in sorted(funcs.items()):
                out.write(f"## {f}\n" + "".join(i + "\n" for i in ins))
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)
rows = []
if "mlp" in phases:
    cs.check_mlp(dev, gen, rows, "mlp_ln", cs.K3_SHAPES)
    cs.check_mlp(dev, gen, rows, "mlp_ln", cs.SWIN_K3_SHAPES, "swin")
    cs.check_mlp(dev, gen, rows, "mlp_ln_res", cs.K4_SHAPES)
    cs.check_mlp_bwd(dev, gen, rows, "mlp_ln_bwd", cs.K3_SHAPES)
    cs.check_mlp_bwd(dev, gen, rows, "mlp_ln_bwd", cs.SWIN_K3_SHAPES, "swin")
    cs.check_mlp_bwd(dev, gen, rows, "mlp_ln_res_bwd", cs.K4_SHAPES)
if "dense" in phases:
    cs.check_dense(dev, gen, rows)
    cs.check_dense(dev, gen, rows, fp32=True)
if "attention" in phases:
    cs.check_attention(dev, gen, rows, cs.K1_SHAPES, "e2e")
    cs.check_attention(dev, gen, rows, cs.SWIN_K1_SHAPES, "swin")
if "layouts" in phases:
    cs.check_layouts(dev, gen, rows)
if "optim" in phases:
    cs.optimizer_phase(dev, rows)
if "k2" in phases:
    from torch.profiler import ProfilerActivity, profile
    from mvuld_tpu_torch.ops import window_attention as wa
    K2_REPS = 3
    bwd = wa.window_attention_flat_bwd
    for path, shapes in (("e2e", cs.K1_SHAPES), ("swin", cs.SWIN_K1_SHAPES)):
        for stage, Bn, N, C, H, shift, nW1, per_fwd in shapes:
            qkv = torch.randn(Bn, N, 3 * C, device=dev, generator=gen
                              ).to(torch.bfloat16)
            bias = 16 * torch.sigmoid(torch.randn(H, N, N, device=dev,
                                                  generator=gen))
            ls = math.log(10.0) + 0.1 * torch.randn(H, device=dev,
                                                    generator=gen)
            o, r = wa.window_attention_flat(qkv, bias, ls, shift, nW1, nW1,
                                            return_rowsum=True)
            g = torch.randn(o.shape, device=dev, generator=gen
                            ).to(torch.bfloat16)
            run = lambda: bwd(qkv, bias, ls, o, r, g, shift, nW1, nW1)  # noqa: E731
            run()
            torch.cuda.synchronize()
            fused = getattr(bwd, "fused_launches", None)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(K2_REPS):
                    run()
                torch.cuda.synchronize()
            if fused is not None:
                fused = (bwd.fused_launches - fused) / K2_REPS
            passes = {}
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    name = e.name.replace("(anonymous namespace)::", "")
                    name = name.split("(")[0].strip()
                    passes[name] = (passes.get(name, 0.0)
                                    + e.time_range.elapsed_us() / 1e3 / K2_REPS)
            shape = (f"stage{stage} Bn={Bn} N={N} C={C} H={H} "
                     f"shift={shift}")
            print(f"AB_K2 [{path}] {shape}: fused_launches per launch "
                  f"{'absent' if fused is None else fused}", flush=True)
            for name, ms in passes.items():
                rows.append(dict(kernel=f"K2:{name}", shape=shape, path=path,
                                 per_fwd=per_fwd, ms=ms, plain_ms=0.0,
                                 err=0.0, tol=0.0, ok=True))
            del qkv, bias, o, r, g
            torch.cuda.empty_cache()
out = [dict(kernel=r["kernel"], shape=r["shape"], path=r["path"],
            per_fwd=r["per_fwd"], ms=r["ms"], plain_ms=r["plain_ms"],
            ok=bool(r.get("ok", r["err"] <= (r["tol"] or 0.0))))
       for r in rows]
print("AB_ROWS " + json.dumps(out), flush=True)
"""


def run_tree(tree: str, phases, sass, dump_to="") -> list:
    proc = subprocess.run([sys.executable, "-c", _CHILD, ",".join(phases),
                           ",".join(sass), dump_to],
                          cwd=tree, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    for line in proc.stdout.splitlines():
        if line.startswith(("AB_SASS ", "AB_K2 ")):
            print(f"{tree}: {line}", flush=True)
    for line in proc.stdout.splitlines():
        if line.startswith("AB_ROWS "):
            return json.loads(line[len("AB_ROWS "):])
    raise RuntimeError(f"{tree}: no result line\n{proc.stdout[-4000:]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", help="source trees, in run order")
    ap.add_argument("--phase", nargs="+", default=["mlp", "dense"],
                    choices=["mlp", "dense", "attention", "layouts", "k2",
                             "optim"])
    ap.add_argument("--sass", nargs="*", default=[],
                    help="libraries (csrc/<name>.cu) to digest")
    ap.add_argument("--sass-dir", default="",
                    help="write each run's listings of those libraries here")
    args = ap.parse_args(argv)
    if args.sass_dir:
        os.makedirs(args.sass_dir, exist_ok=True)
    results = []
    for i, tree in enumerate(args.trees):
        dump_to = (os.path.join(os.path.abspath(args.sass_dir), str(i))
                   if args.sass_dir else "")
        totals = {}
        for r in run_tree(os.path.abspath(tree), args.phase, args.sass,
                          dump_to):
            r.update(tree=tree, run=i)
            results.append(r)
            key = (r["kernel"], r["path"])
            totals[key] = totals.get(key, 0.0) + r["per_fwd"] * r["ms"]
            print(f"run {i} {tree}: {r['kernel']} {r['shape']} [{r['path']}] "
                  f"ms={r['ms']:.3f} plain_ms={r['plain_ms']:.3f} "
                  f"ok={r['ok']}", flush=True)
        for (kernel, path), ms in totals.items():
            print(f"run {i} {tree}: {kernel} [{path}] sum of launches × ms "
                  f"{ms:.3f}", flush=True)
    print(json.dumps({"ab": results}), flush=True)
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
