"""The window-streaming kernel's tile and the fused rank-IC sort, measured
on the card (``csrc/window_stream.cu``, ``csrc/rank_sort.cu``):

1. the tile sweep: the window kernel built once more for each tile of
   :data:`ROWS` dates a thread by :data:`THREADS` columns a block (the
   source's ``WIN_ROWS`` / ``WIN_THREADS`` lines rewritten into a copy under
   ``build/kernels/sweep/``), each build's ``ptxas`` registers and spills,
   and its decay form's device time at the kernel phase's shape
   (D = 5040, N = 5000, W = 150) and summed over the decay sweep's 17
   launches (D = 1332, N = 1000, the windows of ``DEFAULT_DECAY_PERIODS``
   from 2 on), every output held bitwise against the plain version;
2. the SASS of the decay form's float instantiation (``cuobjdump -sass``):
   the instructions of its middle loop (the loop with the most ``FMUL``s)
   by kind, with its ``I2F`` conversions and ``ISETP`` compares;
3. the rank-IC sort's layout: built for 4, 8, 16 and 32 words a thread
   (the source's ``RS_REG_WORDS``), each timed at 66,600 rows of 1000 and
   held bitwise against this checkout's build, and each again with its
   post-sort body cut out, which splits the time between the sort and
   the post-sort body;
4. with ``--parent DIR`` (a directory holding another version's
   ``window_stream.cu``, ``rank_sort.cu`` and ``rank_common.cuh``, e.g. the
   parent commit's, from ``git show``): both kernels of that version and of
   this checkout on the same inputs, in turns (other, this, this, other):
   every window form at the phase's shape and on an edge panel, the decay
   form summed over the decay sweep's 17 launches, and the
   rank-IC sort at 66,600 rows of 1000 and on an edge panel of widths 128
   to 8192; the outputs bit for bit, and the device times.

Needs the card::

    python -m factormodeling_tpu_torch.tile_sweep [--parent DIR]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from factormodeling_tpu_torch import _build
from factormodeling_tpu_torch.analytics import DEFAULT_DECAY_PERIODS
from factormodeling_tpu_torch.ops import _cuda_window as cw

ROWS, THREADS = (8, 16, 32), (64, 128, 256)
PHASE = dict(d=5040, n=5000, w=150)
PATH_D, PATH_N = 1332, 1000
#: the decay sweep's kernel launches: every default window from 2 on
PATH_WINDOWS = tuple(w for w in DEFAULT_DECAY_PERIODS if w >= 2)
NAN_SHARE, SEED, REPS = 0.002, 0, 20
K3_ROWS, K3_N = 66_600, 1000
K3_EDGE_WIDTHS = (128, 129, 300, 1000, 1025, 2048, 4097, 8192)
#: words a thread holds in the rank-IC sort (``RS_REG_WORDS``), swept
REG_WORDS = (4, 8, 16, 32)
_POST_SORT = "  for (int q = 0; q < ROWS && row0 + q < rows; ++q) {"
_SORT_ONLY = ("  if (t == 0 && row < rows)\n"
              "    ic_out[row] = __uint_as_float((unsigned)s_row[swizzle(7)]);"
              "\n  for (int q = 0; q < 0; ++q) {")
_FORMS = {"decay": 0, "rank": 1, "std": 2, "zscore": 3}
_SWEEP_DIR = _build.BUILD_DIR / "sweep"
#: the mangled name's mark of window_stream_kernel<float, FORM_DECAY>
_DECAY_F32 = "window_stream_kernelIfLi0E"
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                    r"\s*([^;]*);")


def ptxas_by_function(lines) -> dict:
    """``{function: "Used .. registers ..; .. spill .."}`` from ``ptxas -v``
    lines in their order."""
    out, fn = {}, None
    for ln in lines:
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            fn = m.group(1)
        elif fn and ("registers" in ln or "spill" in ln):
            out[fn] = "; ".join(filter(None, (out.get(fn), ln.strip())))
    return out


def _nvcc_many(jobs: dict) -> dict:
    """Compile ``{out_path: source_path}`` in parallel; returns each
    library's ``ptxas`` report by function."""
    procs = {out: subprocess.Popen(
        [_build._nvcc(), *_build._NVCC_FLAGS, "-o", str(out), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for out, src in jobs.items()}
    report = {}
    for out, proc in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {jobs[out]}: exit {proc.returncode}\n"
                               f"{stderr}")
        report[out] = ptxas_by_function((stdout + stderr).splitlines())
    return report


def variant_source(lib: str, tag: str, defines: dict,
                   replace: tuple = ()) -> Path:
    """A copy of ``lib``'s source (and the headers beside it) under
    ``build/kernels/sweep/`` with each ``#define NAME value`` of
    ``defines`` set and each ``(old, new)`` of ``replace`` made once."""
    src = _build.source_path(lib).read_text()
    for name, val in defines.items():
        src, hits = re.subn(rf"^#define {name} \d+", f"#define {name} {val}",
                            src, flags=re.M)
        if hits != 1:
            raise RuntimeError(f"{lib}: no single #define {name}")
    for old, new in replace:
        if src.count(old) != 1:
            raise RuntimeError(f"{lib}: {old!r} is not in the source once")
        src = src.replace(old, new)
    _SWEEP_DIR.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, _SWEEP_DIR / header.name)
    path = _SWEEP_DIR / f"{lib}_{tag}.cu"
    path.write_text(src)
    return path


def _window_entry(lib, dtype=torch.float32):
    fn = getattr(lib, cw._ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def window_launch(lib, form: str, x: torch.Tensor, w: int, out=None):
    """One launch of ``lib``'s window kernel on a ``[D, N]`` (or
    ``[R, D, N]``) panel; returns the output."""
    d, n = x.shape[-2:]
    out = torch.empty_like(x) if out is None else out
    rc = _window_entry(lib, x.dtype)(
        x.data_ptr(), out.data_ptr(), _FORMS[form], x.numel() // (d * n), d,
        n, w, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"window kernel ({form}) launch failed: {rc}")
    return out


def device_ms(fn, reps: int = REPS) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def panel(d: int, n: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(d, n)).astype(np.float32)
    x[rng.uniform(size=x.shape) < NAN_SHARE] = np.nan
    return torch.from_numpy(x).cuda()


def _bitwise(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.nan_to_num(-7.0), b.nan_to_num(-7.0)) and \
        torch.equal(a.isnan(), b.isnan())


def sweep() -> list:
    """Each tile's ptxas report and decay device times (phase shape; the
    sum over the decay sweep's launches), held bitwise against plain."""
    tiles = [(r, c) for r in ROWS for c in THREADS]
    jobs = {_SWEEP_DIR / f"libwindow_r{r}_c{c}.so": variant_source(
        "window_stream", f"r{r}_c{c}", {"WIN_ROWS": r, "WIN_THREADS": c})
        for r, c in tiles}
    report = _nvcc_many(jobs)
    x = panel(PHASE["d"], PHASE["n"], SEED)
    xp = panel(PATH_D, PATH_N, SEED + 1)
    want = cw.decay_streaming_plain(x, PHASE["w"])
    want_p = {w: cw.decay_streaming_plain(xp, w) for w in PATH_WINDOWS}
    rows = []
    for out, (r, c) in zip(jobs, tiles):
        lib = ctypes.CDLL(str(out))
        same = _bitwise(window_launch(lib, "decay", x, PHASE["w"]), want)
        same &= all(_bitwise(window_launch(lib, "decay", xp, w), want_p[w])
                    for w in PATH_WINDOWS)
        o, op = torch.empty_like(x), torch.empty_like(xp)
        ms = device_ms(lambda: window_launch(lib, "decay", x, PHASE["w"], o))
        path_ms = sum(device_ms(lambda: window_launch(lib, "decay", xp, w,
                                                      op))
                      for w in PATH_WINDOWS)
        rows.append(dict(rows=r, threads=c, phase_ms=ms, path_ms=path_ms,
                         bitwise_equal_to_plain=bool(same),
                         ptxas=[v for k, v in report[out].items()
                                if _DECAY_F32 in k]))
    return rows


def sass_function(lib_path: Path, symbol: str) -> list:
    """``[(address, opcode, operands)]`` of the function of ``lib_path``
    whose mangled name holds ``symbol`` (``cuobjdump -sass``), branch
    targets given as addresses."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", sass)
    body = next((f for f in funcs if f.split("\n", 1)[0].strip().startswith(
        "_Z") and symbol in f.split("\n", 1)[0]), None)
    if body is None:
        raise RuntimeError(f"{lib_path.name}: no function matching {symbol}")
    labels, instrs, pending = {}, [], []
    for line in body.splitlines():
        lab = re.match(r"^\s*(\.L_x_\d+):", line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = _INSTR.search(line)
        if m:
            addr = int(m.group(1), 16)
            labels.update((name, addr) for name in pending)
            pending = []
            instrs.append((addr, m.group(2), m.group(3)))
    for i, (addr, op, args) in enumerate(instrs):
        lab = re.search(r"(\.L_x_\d+)", args)
        if op.startswith("BRA") and lab and lab.group(1) in labels:
            instrs[i] = (addr, op, f"{labels[lab.group(1)]:#x}")
    return instrs


def opcode_counts(instrs, lo: int = 0, hi: int = 1 << 62) -> dict:
    """Instructions between two addresses by opcode (its first part)."""
    c = {}
    for addr, op, _ in instrs:
        if lo <= addr <= hi:
            base = op.split(".")[0]
            c[base] = c.get(base, 0) + 1
    return dict(sorted(c.items(), key=lambda kv: -kv[1]))


def sass_middle_loop(lib_path: Path, symbol: str = _DECAY_F32) -> dict:
    """The decay form's float instantiation in ``lib_path``: the loop (a
    backward branch) with the most FMULs, its instructions by opcode, and
    the I2F conversions of the whole function."""
    instrs = sass_function(lib_path, symbol)
    loops = []
    for addr, op, args in instrs:
        tgt = re.search(r"0x([0-9a-f]+)", args)
        if op.startswith("BRA") and tgt and int(tgt.group(1), 16) < addr:
            loops.append((int(tgt.group(1), 16), addr))
    if not loops:
        raise RuntimeError(f"{lib_path.name}: {symbol} has no loop")
    mid = max(loops, key=lambda lh: opcode_counts(instrs, *lh).get("FMUL", 0))
    c = opcode_counts(instrs, *mid)
    return dict(loop=[hex(mid[0]), hex(mid[1])], instructions=sum(c.values()),
                fmul=c.get("FMUL", 0), fadd=c.get("FADD", 0),
                i2f=sum(v for k, v in c.items() if k.startswith("I2F")),
                isetp=c.get("ISETP", 0), ldg=c.get("LDG", 0),
                function_i2f=sum(1 for _, op, _ in instrs
                                 if op.startswith("I2F")),
                opcodes=dict(list(c.items())[:12]))


def _parent_libs(parent: Path) -> dict:
    """``window_stream`` and ``rank_sort`` built from the sources in
    ``parent``."""
    out_dir = _build.BUILD_DIR / f"other_{parent.resolve().name}"
    out_dir.mkdir(parents=True, exist_ok=True)
    for name in ("window_stream.cu", "rank_sort.cu", "rank_common.cuh"):
        shutil.copy(parent / name, out_dir / name)
    jobs = {out_dir / "libwindow_stream.so": out_dir / "window_stream.cu",
            out_dir / "librank_sort.so": out_dir / "rank_sort.cu"}
    report = _nvcc_many(jobs)
    return {p.stem[3:]: (ctypes.CDLL(str(p)), report[p], p) for p in jobs}


def _rank_entry(lib):
    fn = lib.fm_rank_ic_fused
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rank_launch(lib, key, rr, ic, cnt):
    rc = _rank_entry(lib)(key.data_ptr(), rr.data_ptr(), ic.data_ptr(),
                          cnt.data_ptr(), key.shape[0], key.shape[1],
                          torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"rank-IC sort launch failed: {rc}")
    return ic, cnt


def _rank_rows(rng, rows: int, n: int, edge: bool):
    f = rng.normal(size=(rows, n)).astype(np.float32)
    f[rng.uniform(size=f.shape) < (0.05 if edge else 0.03)] = np.nan
    f[: rows // 100] = np.round(f[: rows // 100] * 2.0)   # heavy exact ties
    if edge:
        f[1] = 3.0
        f[2] = np.nan
        f[3, ::2] = -0.0
        f[3, :3] = (np.inf, 1e-40, -1e-40)
        f.view(np.uint32)[4, :3] = (0xFFC00000, 0x7FC00001, 0xFFFFFFFF)
        f[5, 1:] = np.nan
    key = torch.from_numpy(f).cuda()
    rr = torch.where(torch.isnan(key), 0.0, torch.from_numpy(
        rng.normal(scale=0.02, size=f.shape).astype(np.float32)).cuda())
    return key, rr


def against_parent(parent: Path) -> dict:
    """Both kernels of ``parent`` and of this checkout on the same inputs:
    outputs bit for bit, device times in turns (other, this, this,
    other)."""
    other = _parent_libs(parent)
    this_w, this_r = _build.load("window_stream"), _build.load("rank_sort")
    res = {"ptxas_parent": {k: v[1] for k, v in other.items()}}
    x = panel(PHASE["d"], PHASE["n"], SEED)
    o = torch.empty_like(x)
    forms = {}
    for form in _FORMS:
        a = window_launch(other["window_stream"][0], form, x, PHASE["w"])
        b = window_launch(this_w, form, x, PHASE["w"])
        run = {lib_name: (lambda lib=lib: window_launch(lib, form, x,
                                                        PHASE["w"], o))
               for lib_name, lib in (("parent", other["window_stream"][0]),
                                     ("this", this_w))}
        t = [device_ms(run[k]) for k in ("parent", "this", "this", "parent")]
        forms[form] = dict(bitwise_equal=_bitwise(a, b),
                           parent_ms=(t[0] + t[3]) / 2, ms=(t[1] + t[2]) / 2,
                           turns=t)
    # the decay sweep's 17 launches, summed
    xp = panel(PATH_D, PATH_N, SEED + 1)
    op = torch.empty_like(xp)
    other_w = other["window_stream"][0]
    path_same = all(_bitwise(window_launch(other_w, "decay", xp, w),
                             window_launch(this_w, "decay", xp, w))
                    for w in PATH_WINDOWS)
    t = [sum(device_ms(lambda w=w, lib=lib: window_launch(lib, "decay", xp, w,
                                                          op))
             for w in PATH_WINDOWS)
         for lib in (other_w, this_w, this_w, other_w)]
    forms["decay_path"] = dict(bitwise_equal=path_same,
                               parent_ms=(t[0] + t[3]) / 2,
                               ms=(t[1] + t[2]) / 2, turns=t)
    rng = np.random.default_rng(SEED + 9)
    edge_same = True
    for shape, dt, windows in (((2, 1040, 130), torch.float32,
                                (2, 3, 7, 15, 16, 17, 31, 33, 100, 350)),
                               ((1040, 130), torch.float64, (5, 100)),
                               ((3, 40, 33), torch.float32, (20, 100))):
        xe = rng.normal(size=shape)
        xe[rng.uniform(size=shape) < 0.02] = np.nan
        xe = torch.from_numpy(xe).to("cuda", dt)
        for w in windows:
            for form in _FORMS:
                edge_same &= _bitwise(
                    window_launch(other["window_stream"][0], form, xe, w),
                    window_launch(this_w, form, xe, w))
    res["window"] = dict(forms=forms, edge_bitwise_equal=bool(edge_same))

    key, rr = _rank_rows(rng, K3_ROWS, K3_N, edge=False)
    outs = [(torch.empty(K3_ROWS, device="cuda"),
             torch.empty(K3_ROWS, device="cuda")) for _ in range(2)]
    libs = {"parent": other["rank_sort"][0], "this": this_r}
    rank_launch(libs["parent"], key, rr, *outs[0])
    rank_launch(libs["this"], key, rr, *outs[1])
    same = _bitwise(outs[0][0], outs[1][0]) and torch.equal(outs[0][1],
                                                            outs[1][1])
    t = [device_ms(lambda k=k: rank_launch(libs[k], key, rr, *outs[1]))
         for k in ("parent", "this", "this", "parent")]
    edge = {}
    for n in K3_EDGE_WIDTHS:
        ke, re_ = _rank_rows(rng, 600, n, edge=True)
        got = [rank_launch(libs[k], ke, re_, torch.empty(600, device="cuda"),
                           torch.empty(600, device="cuda"))
               for k in ("parent", "this")]
        edge[n] = bool(_bitwise(got[0][0], got[1][0])
                       and torch.equal(got[0][1], got[1][1]))
    res["rank_sort"] = dict(rows=K3_ROWS, n=K3_N, bitwise_equal=bool(same),
                            parent_ms=(t[0] + t[3]) / 2, ms=(t[1] + t[2]) / 2,
                            turns=t, edge_bitwise_equal=edge)
    res["sass_parent"] = sass_middle_loop(other["window_stream"][2])
    return res


def rank_sort_sweep() -> list:
    """The rank-IC sort at 66,600 rows of 1000 built for each number of
    words a thread of :data:`REG_WORDS` (256 / E threads, that many warps a
    row at W = 1024), ``ic`` and ``n_valid`` bitwise against this
    checkout's build; and each again with the post-sort body cut out (the
    sort alone, kept live by one word a row stored): the two times split
    the kernel's between the sort and the post-sort body."""
    jobs, cases = {}, []
    for e in REG_WORDS:
        for sort_only in (False, True):
            tag = f"e{e}" + ("_sort_only" if sort_only else "")
            jobs[_SWEEP_DIR / f"librank_sort_{tag}.so"] = variant_source(
                "rank_sort", tag, {"RS_REG_WORDS": e},
                ((_POST_SORT, _SORT_ONLY),) if sort_only else ())
            cases.append((e, sort_only))
    report = _nvcc_many(jobs)
    key, rr = _rank_rows(np.random.default_rng(SEED + 9), K3_ROWS, K3_N,
                         edge=False)

    def outputs():
        return (torch.empty(K3_ROWS, device="cuda"),
                torch.empty(K3_ROWS, device="cuda"))

    ref = rank_launch(_build.load("rank_sort"), key, rr, *outputs())
    rows = []
    for out, (e, sort_only) in zip(jobs, cases):
        lib = ctypes.CDLL(str(out))
        got = rank_launch(lib, key, rr, *outputs())
        same = None if sort_only else bool(
            _bitwise(got[0], ref[0]) and torch.equal(got[1], ref[1]))
        ms = device_ms(lambda: rank_launch(lib, key, rr, *got))
        ops = opcode_counts(sass_function(out, "rank_sort_kernelILi1024E"))
        rows.append(dict(reg_words=e, sort_only=sort_only, ms=ms,
                         bitwise_equal=same,
                         ptxas=[v for k, v in report[out].items()
                                if "ILi1024E" in k],
                         sass_instructions=sum(ops.values()),
                         sass_opcodes=dict(list(ops.items())[:10])))
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="directory with another version's window_stream.cu, "
                         "rank_sort.cu and rank_common.cuh")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tile_sweep measures the card: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    _build.build(("window_stream", "rank_sort"))
    for name, info in _build.BUILD_LOG.items():
        for fn, line in ptxas_by_function(info["ptxas"]).items():
            print(f"ptxas {name} {fn}: {line}", flush=True)
    sass = sass_middle_loop(_build._lib_path("window_stream"))
    print("sass decay<float> middle loop: " + json.dumps(sass), flush=True)
    if args.parent is not None:
        res = against_parent(args.parent)
        for name, report in res.pop("ptxas_parent").items():
            for fn, line in report.items():
                print(f"ptxas parent {name} {fn}: {line}", flush=True)
        print("against parent: " + json.dumps(res), flush=True)
    for row in sweep():
        print("tile " + json.dumps(row), flush=True)
    for row in rank_sort_sweep():
        print("rank_sort layout " + json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
