#!/usr/bin/env python3
"""The f32 fused-head kernel beside variants of its tiling, on one GPU.

Each variant is csrc/fused_head.cu with one or more of its f32 constants
changed (row-tile groups a block, rows a tile) or its GEMMs' K loops not
fully unrolled, compiled by nvcc with the port's flags into
build/fused_head_variants/. Every variant is held to the plain version
(`_head_torch`, rtol 1e-4, atol 1e-5) at ragged sizes around its tiles,
then timed at 2^18 rows (a render chunk), 2^20 rows (a bake chunk) and
2^21 + 3 rows from replayed CUDA graphs, all variants in turns, three
rounds. `--baseline PATH` adds another fused_head.cu (an earlier
commit's, say) as it stands, held to the plain version likewise. Prints the
card, each variant's ptxas registers and spills, the as-built kernel's
instruction mix (cuobjdump's SASS, counted by opcode: the share of FFMA
bounds how close it can come to the FMA rate), and one JSON line of times
(ms).

    python3 scripts/fused_head_f32_variants.py     # from the repo root
    git archive HEAD | tar -x -C build/parent       # build/ is ignored
    python3 scripts/fused_head_f32_variants.py \
        --baseline build/parent/arnerf_tpu_torch/csrc/fused_head.cu
"""

import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from arnerf_tpu_torch import build  # noqa: E402
from arnerf_tpu_torch.ops import fused_head as fh  # noqa: E402

SRC = ROOT / "arnerf_tpu_torch" / "csrc" / "fused_head.cu"
WORK = ROOT / "build" / "fused_head_variants"
GROUPS = "constexpr int kGroups = 3;"
ROWS = "constexpr int kRows = 64;"
K_LOOP = "#pragma unroll\n  for (int k = 0; k < K; k += 4) {"
# an instruction line of cuobjdump -sass: its address, a predicate, opcode
SASS_OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)")
# name: (groups, rows a tile, K-loop unroll or None for full); every one
# fits the 227 KB of shared memory a block may take
VARIANTS = {"as built": (3, 64, None), "2 groups": (2, 64, None),
            "6 groups x 32 rows": (6, 32, None),
            "2 groups x 96 rows": (2, 96, None),
            "1 group x 192 rows": (1, 192, None),
            "K unrolled 2": (3, 64, 2), "K not unrolled": (3, 64, 1)}


def variant_source(groups, rows, unroll):
    src = SRC.read_text()
    for old in (GROUPS, ROWS, K_LOOP):
        if src.count(old) != 1:
            raise RuntimeError(f"{SRC.name} no longer holds {old!r} once")
    src = src.replace(GROUPS, f"constexpr int kGroups = {groups};")
    src = src.replace(ROWS, f"constexpr int kRows = {rows};")
    if unroll is not None:
        src = src.replace(K_LOOP, K_LOOP.replace(
            "#pragma unroll", f"#pragma unroll {unroll}"))
    return src


def build_all(baseline=None):
    """Compile every variant (and the baseline source, if given), all nvcc
    processes started together; returns {name: launch function}."""
    WORK.mkdir(parents=True, exist_ok=True)
    sources = {name: variant_source(*spec) for name, spec in VARIANTS.items()}
    if baseline is not None:
        sources["baseline"] = Path(baseline).read_text()
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        src = WORK / f"variant{i}.cu"
        src.write_text(text)
        lib = WORK / f"libvariant{i}.so"
        procs[name] = (subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        fn = "?"
        for line in log.splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                fn = cs._kernel_name(entry.group(1))
            if fn == "fused_head_f32_kernel" and (
                    "registers" in line or "spill" in line):
                print(f"{name}: {line.strip()}", flush=True)
        f = ctypes.CDLL(str(lib)).arnerf_fused_head_forward
        f.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int64, ctypes.c_int,
                                              ctypes.c_int, ctypes.c_void_p]
        f.restype = ctypes.c_int
        libs[name] = f
    return libs


def sass_mix(lib):
    """Opcode counts of fused_head_f32_kernel in `lib`'s SASS (static:
    each instruction once, the tile loop's body dominating), or None
    without cuobjdump."""
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, inside = {}, False
    for line in sass.splitlines():
        if "Function : " in line:
            inside = "fused_head_f32_kernel" in line
        op = SASS_OP.search(line)
        if inside and op:
            counts[op.group(1)] = counts.get(op.group(1), 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def main() -> int:
    if not torch.cuda.is_available():
        print("fused_head_f32_variants: needs a CUDA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    args = sys.argv[1:]
    if args and (len(args) != 2 or args[0] != "--baseline"):
        print(__doc__, file=sys.stderr)
        return 2
    libs = build_all(args[1] if args else None)
    mix = sass_mix(WORK / "libvariant0.so")
    if mix is None:
        print("as built: SASS mix not measured (no cuobjdump)", flush=True)
    else:
        total = sum(mix.values())
        print(f"as built: {total} SASS instructions, FFMA share "
              f"{mix.get('FFMA', 0) / total:.3f}; by opcode {mix}", flush=True)
    dev = torch.device("cuda")
    w = cs._head_weights(dev)

    def inputs(n):
        g = torch.Generator(device=dev).manual_seed(n)
        return (torch.randn((n, 32), generator=g, device=dev) * 0.5,
                torch.randn((n, 16), generator=g, device=dev) * 0.5,
                torch.full((n, 16), float("nan"), device=dev),
                torch.full((n, 3), float("nan"), device=dev))

    def launch(fn, feats, sh, h, rgb):
        err = fn(feats.data_ptr(), sh.data_ptr(),
                 *(x.data_ptr() for x in w), h.data_ptr(), rgb.data_ptr(),
                 feats.shape[0], 0, 0, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: error {err}")

    for name, fn in libs.items():
        rows = VARIANTS[name][1] if name in VARIANTS else 128
        for n in (1, rows - 1, rows, rows + 1, 3 * rows + 5, 50_001,
                  (1 << 18) + 5):
            feats, sh, h, rgb = inputs(n)
            launch(fn, feats, sh, h, rgb)
            torch.cuda.synchronize()
            h_p, rgb_p = fh._head_torch(feats, sh, w, torch.float32)
            torch.testing.assert_close(h, h_p, rtol=1e-4, atol=1e-5)
            torch.testing.assert_close(rgb, rgb_p, rtol=1e-4, atol=1e-5)
        print(f"{name}: matches the plain version", flush=True)

    times = {}
    for n in (cs.MAIN_PATH_ROWS, cs.BAKE_ROWS, cs.PARITY_ROWS):
        tensors = inputs(n)
        runs = {name: [] for name in libs}
        order = list(libs)
        for rnd in range(3):
            for name in (order if rnd % 2 == 0 else order[::-1]):
                runs[name].append(cs._time_graph_ms(
                    lambda fn=libs[name]: launch(fn, *tensors), 20))
        times[str(n)] = runs
    print(json.dumps({"card": cs.card_line().splitlines()[0],
                      "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
