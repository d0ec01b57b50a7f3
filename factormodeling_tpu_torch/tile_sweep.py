"""The window-streaming kernel's tile, the fused rank-IC sort, the fused
z-score/group-neutralize kernel and the rank-IC post-sort kernel, measured
on the card (``csrc/window_stream.cu``, ``csrc/rank_sort.cu``,
``csrc/zscore_group.cu``, ``csrc/rank_ic.cu``), in five parts:

1. ``tile``: the window kernel built once more for each tile of
   :data:`ROWS` dates a thread by :data:`THREADS` columns a block (the
   source's ``WIN_ROWS`` / ``WIN_THREADS`` lines rewritten into a copy under
   ``build/kernels/sweep/``), each build's ``ptxas`` registers and spills,
   and its decay form's device time at the kernel phase's shape
   (D = 5040, N = 5000, W = 150) and summed over the decay sweep's 17
   launches (D = 1332, N = 1000, the windows of ``DEFAULT_DECAY_PERIODS``
   from 2 on), every output held bitwise against the plain version;
2. ``layout``: the rank-IC sort built for 4, 8, 16 and 32 words a thread
   (the source's ``RS_REG_WORDS``), each timed at 66,600 rows of 1000 and
   held bitwise against this checkout's build, and each again with its
   post-sort body cut out, which splits the time between the sort and
   the post-sort body;
3. ``split`` (with ``--parent DIR`` holding the block-a-row sources of
   the two kernels, those before their register and team designs; on any
   other sources its edits raise): those kernels built whole and with a
   part cut out (:data:`SPLIT_VARIANTS`: load and store alone, no group
   passes, the ids of one date for every row; the row load alone, no block
   scans), timed at [50, 1260, 3000] and [50, 1332, 1000] (G = 11) and at
   66,600 rows of 1000: the split that the redesign started from;
4. ``variants``: this checkout's z-score/group-neutralize, post-sort and
   fused-sort kernels built whole and with a part cut out or another walk
   (:data:`THIS_VARIANTS`: source edits made in a copy), timed at the same
   shapes, each with its ``ptxas`` report, and the SASS opcode counts of
   :data:`SASS_OF`;
5. ``parent`` (with ``--parent DIR``, a directory holding another
   version's ``window_stream.cu``, ``rank_sort.cu``, ``zscore_group.cu``,
   ``rank_ic.cu`` and ``rank_common.cuh``, e.g. the parent commit's, from
   ``git show``): the kernels of that version and of this checkout on the
   same inputs, timed in turns (other, this, this, other): every window
   form at the phase's shape and on an edge panel, the decay form summed
   over the decay sweep's 17 launches, the SASS of the decay form's middle
   loop; the rank-IC sort at 66,600 rows of 1000 and on an edge panel of
   widths 128 to 8192; the z-score/group-neutralize kernel at both shapes,
   on an edge panel and at its forms' width boundaries in float32 and
   float64; the post-sort kernel at 66,600 rows of 1000 and on edge widths
   1 to 16384. Window outputs are compared bit for bit; the others by
   max |diff| against each other and against their plain versions.

Needs the card::

    python -m factormodeling_tpu_torch.tile_sweep [--parent DIR]
        [--parts tile,layout,variants,parent]
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
from factormodeling_tpu_torch.metrics import _cuda_rank_ic as rk
from factormodeling_tpu_torch.metrics import _cuda_rank_sort as rs
from factormodeling_tpu_torch.ops import _cuda_fused as cf
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
_POST_SORT = "  if (pteam < teams) {"
_SORT_ONLY = ("  if (t == 0 && row < rows)\n"
              "    ic_out[row] = __uint_as_float((unsigned)s_row[swizzle(7)]);"
              "\n  if (false) {")
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
                   replace: tuple = (), src_dir: Path | None = None,
                   header_replace: dict | None = None) -> Path:
    """A copy of ``lib``'s source (from ``src_dir``, by default this
    checkout's ``csrc/``) and the headers beside it, in a directory of its
    own under ``build/kernels/sweep/``, with each ``#define NAME value`` of
    ``defines`` set, each ``(old, new)`` of ``replace`` made once in the
    source and each of ``header_replace[name]`` once in that header."""
    src_dir = _build.CSRC if src_dir is None else Path(src_dir)
    src = (src_dir / _build.KERNEL_SOURCES[lib]).read_text()
    for name, val in defines.items():
        src, hits = re.subn(rf"^#define {name} \d+", f"#define {name} {val}",
                            src, flags=re.M)
        if hits != 1:
            raise RuntimeError(f"{lib}: no single #define {name}")
    src = _replace_once(lib, src, replace)
    out_dir = _SWEEP_DIR / f"{lib}_{tag}"
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in src_dir.glob("*.cuh"):
        text = _replace_once(header.name, header.read_text(),
                             (header_replace or {}).get(header.name, ()))
        (out_dir / header.name).write_text(text)
    path = out_dir / f"{lib}.cu"
    path.write_text(src)
    return path


def _replace_once(name: str, text: str, replace) -> str:
    for old, new in replace:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} is not in the source once")
        text = text.replace(old, new)
    return text


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


#: the libraries ``--parent`` builds from the other version's sources
PARENT_LIBS = ("window_stream", "rank_sort", "zscore_group", "rank_ic")


def _parent_libs(parent: Path) -> dict:
    """:data:`PARENT_LIBS` built from the sources in ``parent``."""
    out_dir = _build.BUILD_DIR / f"other_{parent.resolve().name}"
    out_dir.mkdir(parents=True, exist_ok=True)
    for name in [_build.KERNEL_SOURCES[n] for n in PARENT_LIBS]:
        shutil.copy(parent / name, out_dir / name)
    for header in parent.glob("*.cuh"):
        shutil.copy(header, out_dir / header.name)
    jobs = {out_dir / f"lib{n}.so": out_dir / _build.KERNEL_SOURCES[n]
            for n in PARENT_LIBS}
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
    libs = {"parent": other["rank_sort"][0], "this": this_r}
    got = {k: rank_launch(libs[k], key, rr,
                          torch.empty(K3_ROWS, device="cuda"),
                          torch.empty(K3_ROWS, device="cuda"))
           for k in libs}
    plain = rs.rank_ic_fused_plain(key, rr)
    t = [device_ms(lambda k=k: rank_launch(libs[k], key, rr, *got[k]))
         for k in ("parent", "this", "this", "parent")]
    edge = {}
    for n in K3_EDGE_WIDTHS:
        ke, re_ = _rank_rows(rng, 600, n, edge=True)
        ge = {k: rank_launch(libs[k], ke, re_,
                             torch.empty(600, device="cuda"),
                             torch.empty(600, device="cuda")) for k in libs}
        edge[n] = _compare(ge, rs.rank_ic_fused_plain(ke, re_))
    res["rank_sort"] = dict(rows=K3_ROWS, n=K3_N, **_compare(got, plain),
                            parent_ms=(t[0] + t[3]) / 2, ms=(t[1] + t[2]) / 2,
                            turns=t, edge=edge)
    res["zscore_group"] = zscore_against_parent(other["zscore_group"][0])
    res["rank_ic"] = rank_ic_against_parent(other["rank_ic"][0])
    res["sass_parent"] = sass_middle_loop(other["window_stream"][2])
    return res


def _maxdiff(a: torch.Tensor, b: torch.Tensor) -> float:
    """Max |a - b| where both are defined (-1 if the NaN patterns differ)."""
    if not torch.equal(torch.isnan(a), torch.isnan(b)):
        return -1.0
    return float((a - b).abs().nan_to_num().max()) if a.numel() else 0.0


def _compare(got: dict, plain) -> dict:
    """This version's and the parent's outputs (a tensor, or (ic, n_valid))
    against each other and against the plain version: max |diff| (-1 where
    the NaN patterns differ), n_valid equal."""
    if isinstance(plain, torch.Tensor):
        return dict(diff_parent=_maxdiff(got["this"], got["parent"]),
                    err_this=_maxdiff(got["this"], plain),
                    err_parent=_maxdiff(got["parent"], plain),
                    bitwise_equal=_bitwise(got["this"], got["parent"]))
    return dict(diff_parent=_maxdiff(got["this"][0], got["parent"][0]),
                err_this=_maxdiff(got["this"][0], plain[0]),
                err_parent=_maxdiff(got["parent"][0], plain[0]),
                n_valid_equal=bool(torch.equal(got["this"][1], plain[1])
                                   and torch.equal(got["parent"][1],
                                                   plain[1])),
                bitwise_equal=_bitwise(got["this"][0], got["parent"][0]))


def zscore_against_parent(other) -> dict:
    """K5 of this checkout and of the parent at both shapes (timed in
    turns), on an edge panel (N = 200, G = 5: ids -1 and past G, a constant
    and an all-NaN date, an empty and a one-member group), at the forms'
    width boundaries and on rows of 20,000 in float32 and float64."""
    this = _build.load("zscore_group")
    libs = {"parent": other, "this": this}
    res = {}
    for shape in K5_SHAPES:
        x, gid = group_case(shape)
        got = {k: zg_launch(h, x, gid, K5_G) for k, h in libs.items()}
        row = _compare(got, cf.zscore_group_neutralize_plain(x, gid, K5_G))
        o = torch.empty_like(x)
        t = [device_ms(lambda k=k: zg_launch(libs[k], x, gid, K5_G, o))
             for k in ("parent", "this", "this", "parent")]
        res["x".join(map(str, shape))] = dict(
            row, parent_ms=(t[0] + t[3]) / 2, ms=(t[1] + t[2]) / 2, turns=t,
            layout=cf.kernel_layout(shape[-1], K5_G, 4))
        del x, gid, got, o
    edge = {}
    for shape, g, dt in (((2, 600, 200), 5, torch.float32),
                         ((2, 40, 1024), 5, torch.float32),
                         ((2, 40, 1025), 5, torch.float32),
                         ((2, 24, 8192), K5_G, torch.float32),
                         ((2, 24, 8193), K5_G, torch.float32),
                         ((2, 24, 16385), K5_G, torch.float32),
                         ((2, 24, 20000), K5_G, torch.float32),
                         ((2, 24, 3000), K5_G, torch.float64),
                         ((2, 24, 20000), K5_G, torch.float64)):
        x, gid = group_case(shape, g, SEED + 3, dt)
        x[0, 3] = 7.5
        x[1, 4] = float("nan")
        gid[5] = min(4, g - 1)
        gid[7] = 0
        gid[7, 9] = 3
        gid[8, 11] = g + 2
        got = {k: zg_launch(h, x, gid, g) for k, h in libs.items()}
        edge["x".join(map(str, shape)) + f" {dt}"] = _compare(
            got, cf.zscore_group_neutralize_plain(x, gid, g))
    res["edge"] = edge
    return res


def rank_ic_against_parent(other) -> dict:
    """K1 of this checkout and of the parent at 66,600 rows of 1000 (timed
    in turns) and on edge rows of widths 1 to 16384 (ties, an all-NaN row,
    signed zeros)."""
    this = _build.load("rank_ic")
    libs = {"parent": other, "this": this}
    s_key, r_s = sorted_rows(K1_ROWS, K1_M)
    got = {k: ric_launch(h, s_key, r_s) for k, h in libs.items()}
    res = dict(rows=K1_ROWS, m=K1_M,
               **_compare(got, rk.rank_ic_postsort_plain(s_key, r_s)))
    t = [device_ms(lambda k=k: ric_launch(libs[k], s_key, r_s, *got[k]))
         for k in ("parent", "this", "this", "parent")]
    res.update(parent_ms=(t[0] + t[3]) / 2, ms=(t[1] + t[2]) / 2, turns=t,
               layout=rk.postsort_layout(K1_M))
    edge = {}
    for m in K1_EDGE_WIDTHS:
        sk, rr = sorted_rows(300, m, SEED + m)
        sk[1] = float("nan")
        rr[1] = 0.0
        sk[2] = 0.0
        sk[2, ::2] = -0.0
        ge = {k: ric_launch(h, sk, rr) for k, h in libs.items()}
        edge[m] = _compare(ge, rk.rank_ic_postsort_plain(sk, rr))
    res["edge"] = edge
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


#: the fused z-score/group-neutralize kernel's shapes: the kernel phase's
#: (bench.py's composite_ops) and path 4's own; G groups
K5_SHAPES = ((50, 1260, 3000), (50, 1332, 1000))
K5_G, K5_NAN = 11, 0.03
#: the rank-IC post-sort kernel's rows and the widths of its edge panel
K1_ROWS, K1_M = 66_600, 1000
K1_EDGE_WIDTHS = (1, 31, 33, 1000, 4096, 16384)
#: today's K5 and K1 with a part cut out, to split their time: (library,
#: tag, source edits, header edits). The edits are those of the sources
#: before the Hopper redesign (the parent of that change).
SPLIT_VARIANTS = (
    ("zscore_group", "full", {}, (), {}),
    ("zscore_group", "load_store", {},
     (("  sum = block_sum(sum, s_red);\n",
       "  __syncthreads();\n"
       "  for (int i = threadIdx.x; i < N; i += ZG_THREADS)\n"
       "    orow[i] = z[i] + (T)g[i];\n"
       "  return;\n"
       "  sum = block_sum(sum, s_red);\n"),), {}),
    ("zscore_group", "no_group_passes", {},
     (("for (int grp = 0; grp < G; ++grp) {",
       "for (int grp = 0; grp < 0; ++grp) {"),), {}),
    ("zscore_group", "ids_one_date", {},
     (("const int* gr = gids + (row % D) * (int64_t)N;",
       "const int* gr = gids;"),), {}),
    ("rank_ic", "full", {}, (), {}),
    ("rank_ic", "load_only", {},
     (("  rank_ic_sorted_row(FloatRow{k, r}, first, m, sum_r, cnt, "
       "ic_out + row,\n                     cnt_out + row);",
       "  if (threadIdx.x == 0) {\n"
       "    ic_out[row] = sum_r + k[0];\n"
       "    cnt_out[row] = cnt + r[m - 1];\n"
       "  }"),), {}),
    ("rank_ic", "no_block_scans", {}, (),
     {"rank_common.cuh": ((
         "  const int fcarry = block_excl_prefix_max(run, s_w0);\n"
         "  const int lcarry = block_excl_suffix_min(first_end, m, s_w1);",
         "  const int fcarry = run;\n"
         "  const int lcarry = first_end;"),)}),
)


#: this checkout's K5, K1 and K3 built whole, with a part cut out, and with
#: another walk or team (``variants`` part): (library, tag, #defines,
#: source edits, header edits)
THIS_VARIANTS = (
    ("zscore_group", "full", {}, (), {}),
    ("zscore_group", "row_major", {},
     (("  const int d = u / F;\n  return (u - d * F) * D + d;",
       "  return u;"),), {}),
    ("zscore_group", "ids_from_l2", {},
     (("  return n * (int)(sizeof(T) + 4);", "  return n * (int)sizeof(T);"),
      ("        bulk_load(sid, gg, 4u * N, &sh.bar[team]);\n", ""),
      ("        cp_async<4>(sid + i, gg + i);\n", ""),
      ("gi[c] = i < N ? sid[i] : -1;",
       "gi[c] = i < N ? gids[(int64_t)(row % D) * N + i] : -1;")), {}),
    ("zscore_group", "min_blocks3", {"ZG_MIN_BLOCKS": 3}, (), {}),
    ("zscore_group", "no_group_table", {},
     (("      GroupAcc<T>& e = tab[gi[c] * 32 + lane];\n"
       "      e.s += v[c];\n"
       "      e.c += T(1);\n", ""),), {}),
    ("zscore_group", "load_store", {},
     (("    for (int g = 0; g <= G; ++g) tab[g * 32 + lane] = "
       "GroupAcc<T>{T(0), T(0)};\n",
       "#pragma unroll\n"
       "    for (int c = 0; c < C; ++c)\n"
       "      if (c * TT + t < N)\n"
       "        __stcs(out + (int64_t)row * N + c * TT + t, v[c] + (T)gi[c]);"
       "\n    continue;\n"),), {}),
    ("rank_ic", "full", {}, (), {}),
    ("rank_ic", "load_only", {},
     (("    rank_ic_team_row(FloatRow{buf, buf + mpad}, m, ch, team, tw, w, "
       "lane, sc,\n                     slot, ic_out + row, cnt_out + row);",
       "    if (t == 0) {\n"
       "      ic_out[row] = buf[0] + buf[mpad + m - 1];\n"
       "      cnt_out[row] = buf[m - 1];\n"
       "    }"),), {}),
) + tuple(
    (lib, f"chunk{ch}", {}, (),
     {"rank_common.cuh": (("#define RIC_MAX_CHUNK 31",
                           f"#define RIC_MAX_CHUNK {ch}"),)})
    for ch in (15,) for lib in ("rank_ic", "rank_sort")) + (
    ("rank_sort", "full", {}, (), {}),)
#: the instantiations whose SASS the ``variants`` part counts: (library,
#: mark of the mangled name)
SASS_OF = (("zscore_group", "zscore_group_regsIfLi32ELb1E"),
           ("zscore_group", "zscore_group_regsIfLi24ELb1E"),
           ("rank_ic", "rank_ic_postsort_kernelILb1E"),
           ("rank_sort", "rank_sort_kernelILi1024E"))


def _zg_entry(lib, dtype=torch.float32):
    fn = getattr(lib, {torch.float32: "fm_zscore_group_f32",
                       torch.float64: "fm_zscore_group_f64"}[dtype])
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def zg_launch(lib, x: torch.Tensor, gid: torch.Tensor, g: int, out=None):
    """One launch of ``lib``'s z-score/group-neutralize kernel on
    ``x [..., D, N]`` with int32 ``gid [D, N]``; returns the output."""
    d, n = x.shape[-2:]
    out = torch.empty_like(x) if out is None else out
    rc = _zg_entry(lib, x.dtype)(x.data_ptr(), gid.data_ptr(),
                                 out.data_ptr(), x.numel() // n, d, n, g,
                                 torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"zscore_group launch failed: {rc}")
    return out


def _ric_entry(lib):
    fn = lib.fm_rank_ic_postsort
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ric_launch(lib, s_key, r_s, ic=None, cnt=None):
    """One launch of ``lib``'s rank-IC post-sort kernel on sorted
    ``[R, M]`` rows; returns (ic, n_valid)."""
    rows = s_key.shape[0]
    ic = torch.empty(rows, device="cuda") if ic is None else ic
    cnt = torch.empty(rows, device="cuda") if cnt is None else cnt
    rc = _ric_entry(lib)(s_key.data_ptr(), r_s.data_ptr(), ic.data_ptr(),
                         cnt.data_ptr(), rows, s_key.shape[1],
                         torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"rank_ic_postsort launch failed: {rc}")
    return ic, cnt


def group_case(shape, g: int = K5_G, seed: int = SEED, dtype=torch.float32):
    """x [F, D, N] (normal, 3% NaN) and int32 ids [D, N] in [0, g) with 1%
    at -1, drawn on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
    x[torch.rand(shape, generator=gen, device="cuda") < K5_NAN] = float("nan")
    gid = torch.randint(0, g, shape[-2:], generator=gen, device="cuda",
                        dtype=torch.int32)
    gid[torch.rand(shape[-2:], generator=gen, device="cuda") < 0.01] = -1
    return x, gid


def sorted_rows(rows: int, m: int, seed: int = SEED):
    """Rows sorted by key (3% NaN, sent last; the first 1% of rows with
    heavy exact ties) and the co-sorted payload, 0 at invalid cells."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    key = torch.randn(rows, m, generator=gen, device="cuda")
    key[torch.rand(rows, m, generator=gen, device="cuda") < 0.03] = \
        float("nan")
    key[: rows // 100] = torch.round(key[: rows // 100] * 2.0)
    r = 0.02 * torch.randn(rows, m, generator=gen, device="cuda")
    r = torch.where(torch.isnan(key), 0.0, r)
    s_key, idx = torch.sort(key, dim=-1)
    return s_key, torch.gather(r, -1, idx)


def _bytes_ms(nbytes: float) -> float:
    return nbytes / 3.35e12 * 1e3


def split_sweep(src_dir: Path | None, variants) -> list:
    """K5, K1 and K3 of the sources in ``src_dir`` (this checkout's when
    None) built as each of ``variants`` ((library, tag, #defines, source
    edits, header edits)): each build's device time at K5's two shapes
    (G = 11), at K1's and K3's 66,600 rows of 1000, beside the bytes bound
    (3.35 TB/s), and its ``ptxas`` report."""
    jobs, cases = {}, []
    for lib, tag, defines, rep, hdr in variants:
        name = f"{'this' if src_dir is None else 'other'}_{tag}"
        out = _SWEEP_DIR / f"lib{lib}_{name}.so"
        jobs[out] = variant_source(lib, name, defines, rep, src_dir, hdr)
        cases.append((lib, tag))
    report = _nvcc_many(jobs)
    rows = []

    def row(lib, tag, shape, ms, nbytes, out):
        rows.append(dict(kernel=lib, variant=tag, shape=list(shape), ms=ms,
                         bound_ms=_bytes_ms(nbytes),
                         ptxas=list(report[out].values())))

    for shape in K5_SHAPES:
        x, gid = group_case(shape)
        o = torch.empty_like(x)
        for out, (lib, tag) in zip(jobs, cases):
            if lib == "zscore_group":
                h = ctypes.CDLL(str(out))
                row(lib, tag, shape,
                    device_ms(lambda: zg_launch(h, x, gid, K5_G, o)),
                    8.0 * x.numel() + 4.0 * gid.numel(), out)
        del x, gid, o
    s_key, r_s = sorted_rows(K1_ROWS, K1_M)
    key, rr = _rank_rows(np.random.default_rng(SEED + 9), K3_ROWS, K3_N,
                         edge=False)
    for out, (lib, tag) in zip(jobs, cases):
        h = ctypes.CDLL(str(out))
        if lib == "rank_ic":
            ic, cnt = ric_launch(h, s_key, r_s)
            row(lib, tag, (K1_ROWS, K1_M),
                device_ms(lambda: ric_launch(h, s_key, r_s, ic, cnt)),
                8.0 * K1_ROWS * K1_M + 8.0 * K1_ROWS, out)
        elif lib == "rank_sort":
            ic, cnt = (torch.empty(K3_ROWS, device="cuda") for _ in range(2))
            row(lib, tag, (K3_ROWS, K3_N),
                device_ms(lambda: rank_launch(h, key, rr, ic, cnt)),
                8.0 * K3_ROWS * K3_N + 8.0 * K3_ROWS, out)
    return rows


PARTS = ("tile", "layout", "split", "variants", "parent")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="directory with another version's window_stream.cu, "
                         "rank_sort.cu, zscore_group.cu, rank_ic.cu and "
                         "rank_common.cuh")
    ap.add_argument("--parts", default=",".join(PARTS),
                    help="comma-separated parts to run, of "
                         f"{', '.join(PARTS)} (split and parent need "
                         "--parent)")
    args = ap.parse_args()
    parts = set(args.parts.split(","))
    if not parts <= set(PARTS):
        raise SystemExit(f"unknown parts {sorted(parts - set(PARTS))}")
    if not torch.cuda.is_available():
        raise SystemExit("tile_sweep measures the card: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    _build.build(("window_stream", "rank_sort", "zscore_group", "rank_ic"))
    for name, info in _build.BUILD_LOG.items():
        for fn, line in ptxas_by_function(info["ptxas"]).items():
            print(f"ptxas {name} {fn}: {line}", flush=True)
    if "split" in parts and args.parent is not None:
        for row in split_sweep(args.parent, SPLIT_VARIANTS):
            print("split " + json.dumps(row), flush=True)
    if "variants" in parts:
        for lib, mark in SASS_OF:
            ops = opcode_counts(sass_function(_build._lib_path(lib), mark))
            print(f"sass {mark}: " + json.dumps(dict(
                instructions=sum(ops.values()), opcodes=dict(
                    list(ops.items())[:16]))), flush=True)
        for row in split_sweep(None, THIS_VARIANTS):
            print("variant " + json.dumps(row), flush=True)
    if "parent" in parts and args.parent is not None:
        sass = sass_middle_loop(_build._lib_path("window_stream"))
        print("sass decay<float> middle loop: " + json.dumps(sass),
              flush=True)
        res = against_parent(args.parent)
        for name, report in res.pop("ptxas_parent").items():
            for fn, line in report.items():
                print(f"ptxas parent {name} {fn}: {line}", flush=True)
        print("against parent: " + json.dumps(res), flush=True)
    if "tile" in parts:
        for row in sweep():
            print("tile " + json.dumps(row), flush=True)
    if "layout" in parts:
        for row in rank_sort_sweep():
            print("rank_sort layout " + json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
