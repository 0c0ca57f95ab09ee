"""The float32 flash-attention kernels (3xTF32 on the tensor cores) at
other tile sizes, on one NVIDIA GPU: for each variant of the ``f32::Cfg``
constants of ``flash_attention.cu`` and ``flash_attention_bwd.cu`` it
builds a copy of the two sources with those constants (into
``build/f32_tiles/``, one nvcc per source, all at once), logs each
instance's registers, spills, shared memory and blocks an SM, holds the
forward and the backward against their plain versions and the 3xTF32
emulation at the float32 rows of ``chip_smoke.py`` phase 2 (its bars),
and times them warm and cold beside the plain version and SDPA's
float32 call.

    python3 tools/flash_f32_tiles.py               # every variant
    python3 tools/flash_f32_tiles.py base q_regs   # some of them
    python3 tools/flash_f32_tiles.py base old=DIR  # against other sources

A variant sets, per instance width (64, 128, 256), the forward's key
tile ``fwd_bk`` and the warps it splits each into (``fwd_split``, 1 or
2), whether Q's split parts stay in registers
(``fwd_qregs``: up to that width) and the k steps of S unrolled at once
where they do not (``fwd_ku``), the backward's q step ``bwd_bq``, key
step ``bwd_bk``, the warps each step splits into ``bwd_parts`` (1 or 2)
and k steps unrolled at once ``bwd_ku``, and, in both, the n tiles
issued term by term in P V, dS K and the like (``group``); ``base`` is
the committed source. The copies are the committed sources with those
lines rewritten, nothing else. ``label=DIR`` runs the two sources found
in DIR as they are (an earlier version, say).
"""
import json
import re
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

sys.path.insert(0, str(cs.ROOT / "src"))

SRC = cs.ROOT / "src/repro_torch/kernels/flash_attention"
BASE = dict(fwd_bk=(64, 64, 32), fwd_split=(2, 2, 2), fwd_qregs=64,
            fwd_ku=(4, 4, 4),
            bwd_bq=(32, 32, 16), bwd_bk=(32, 32, 16), bwd_parts=(2, 2, 1),
            bwd_ku=(2, 2, 2), group=4)
VARIANTS = {
    "base": {},
    # one warp a row group (4 warps, 2 blocks an SM at hd <= 128)
    "split1": dict(fwd_split=(1, 1, 1), fwd_bk=(64, 32, 32)),
    "split1_bk16": dict(fwd_split=(1, 1, 1), fwd_bk=(64, 16, 16)),
    "fwd_bk32": dict(fwd_bk=(32, 32, 32)),
    "q_regs": dict(fwd_qregs=128),
    "fwd_ku2": dict(fwd_ku=(2, 2, 2)),
    "fwd_ku8": dict(fwd_ku=(8, 8, 8)),
    # one warp a row group in the backward (4 warps, 2 blocks an SM)
    "bwd_parts1": dict(bwd_parts=(1, 1, 1), bwd_bq=(32, 16, 16),
                       bwd_bk=(32, 16, 16)),
    "bwd_64": dict(bwd_bq=(64, 32, 16), bwd_bk=(64, 32, 16)),
    "bwd_ku4": dict(bwd_ku=(4, 4, 4)),
    "group2": dict(group=2),
    "group8": dict(group=8),
}
# (name, B, S, window, Hq, Hkv, hd): phase 2's float32 rows and
# train_100m_torch.py --preset 100m's attention
FWD_ROWS = [
    ("mesh_tp_f32", 4, 512, 0, 6, 1, 128),
    ("mesh_moe_tp_f32", 2, 512, 0, 8, 8, 128),
    ("mesh_recurrentgemma_f32", 2, 512, 2048, 10, 1, 256),
    ("train100m_f32", 8, 64, 0, 10, 2, 64),
    ("hd256_f32", 1, 128, 0, 4, 1, 256),
    ("case1", 1, 256, 0, 8, 8, 64),
    ("case4", 1, 160, 48, 8, 2, 64),
]
BWD_ROWS = [
    ("train_f32", 2, 512, 0, 12, 2, 128),
    ("mesh_moe_tp_f32", 2, 512, 0, 8, 8, 128),
    ("mesh_recurrentgemma_f32", 2, 512, 2048, 10, 1, 256),
    ("train100m_f32", 8, 64, 0, 10, 2, 64),
    ("case4", 1, 160, 48, 8, 2, 64),
]


def ternary(widths) -> str:
    a, b, c = widths
    return f"D >= 256 ? {c} : D >= 128 ? {b} : {a}"


def variant_sources(name: str, spec: dict) -> dict:
    """The two sources with the variant's constants, written under
    build/f32_tiles/<name>/ (the file names kept: the libraries export
    <stem>_error_string)."""
    cfg = {**BASE, **spec}
    out = {}
    for stem in ("flash_attention", "flash_attention_bwd"):
        text = (SRC / f"{stem}.cu").read_text()
        head, f32 = text.split("namespace f32 {", 1)
        if stem == "flash_attention":
            f32, n = re.subn(r"(static constexpr int BK = )[^;]+;",
                             rf"\g<1>{ternary(cfg['fwd_bk'])};", f32, 1)
            f32, m = re.subn(r"(static constexpr bool kQInRegs = D <= )\d+;",
                             rf"\g<1>{cfg['fwd_qregs']};", f32, 1)
            f32, u = re.subn(
                r"(static constexpr int kKUnroll = kQInRegs \? D / 8 : )"
                r"[^;]+;", rf"\g<1>{ternary(cfg['fwd_ku'])};", f32, 1)
            f32, v = re.subn(r"(static constexpr int kSplit = )[^;]+;",
                             rf"\g<1>{ternary(cfg['fwd_split'])};", f32, 1)
            assert n == m == u == v == 1
        else:
            f32, n = re.subn(r"(static constexpr int BQ = )[^;]+;",
                             rf"\g<1>{ternary(cfg['bwd_bq'])};", f32, 1)
            f32, m = re.subn(r"(static constexpr int BK = )[^;]+;",
                             rf"\g<1>{ternary(cfg['bwd_bk'])};", f32, 1)
            f32, u = re.subn(r"(static constexpr int kKUnroll = )[^;]+;",
                             rf"\g<1>{ternary(cfg['bwd_ku'])};", f32, 1)
            f32, v = re.subn(r"(static constexpr int kParts = )[^;]+;",
                             rf"\g<1>{ternary(cfg['bwd_parts'])};", f32, 1)
            assert n == m == u == v == 1
        f32, k = re.subn(r"(static constexpr int kGroup = )\d+;",
                         rf"\g<1>{cfg['group']};", f32, 1)
        assert k == 1
        d = cs.ROOT / "build" / "f32_tiles" / name
        d.mkdir(parents=True, exist_ok=True)
        path = d / f"{stem}.cu"
        path.write_text(head + "namespace f32 {" + f32)
        out[stem] = path
    return out


def inputs(B, S, Hq, Hkv, hd, seed, n=4):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(sh, generator=g, device="cuda")
            for sh in ((B, S, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd),
                       (B, S, Hq, hd))[:n]]


def sdpa(window, S):
    F = torch.nn.functional
    if not window:
        return lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)
    i = torch.arange(S, device="cuda")
    mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
    return lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True)


def fwd_row(kernels, ref, row, with_library):
    name, B, S, window, Hq, Hkv, hd = row
    q, k, v = inputs(B, S, Hq, Hkv, hd, seed=S + hd, n=3)
    got = kernels.flash_attention(q, k, v, window=window)
    want = kernels.attention_ref(q, k, v, window=window)
    emu = ref.attention_tiled_ref(q, k, v, window=window,
                                  p_dtype=torch.float32, products="3xtf32")
    err = cs.check_close("flash_attention", name, got, want, torch.float32)
    emu_err = cs.check_close("flash_attention (emulation)", name, got, emu,
                             torch.float32)
    fns = dict(kernel=lambda: kernels.flash_attention(q, k, v,
                                                      window=window))
    if with_library:
        lib = sdpa(window, S)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        fns.update(plain=lambda: kernels.attention_ref(q, k, v,
                                                       window=window),
                   library=lambda: lib(qh, kh, vh))
    ms = cs.median_ms(fns, ())
    ms["kernel_cold"] = cs.cold_ms(
        lambda *a: kernels.flash_attention(*a, window=window),
        cs.cold_copies((q, k, v)))
    return dict(name=name, max_abs_err=err, emulation_max_abs_err=emu_err,
                **ms)


def bwd_row(kernels, fops, ref, row, with_library):
    name, B, S, window, Hq, Hkv, hd = row
    q, k, v, do = inputs(B, S, Hq, Hkv, hd, seed=S + hd + window + 1)
    out, lse = fops.flash_attention_fwd(q, k, v, True, window)
    grads = fops.flash_attention_bwd(q, k, v, out, lse, do, True, window)
    again = fops.flash_attention_bwd(q, k, v, out, lse, do, True, window)
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        raise AssertionError(f"{name}: two calls differ")
    want = kernels.attention_bwd_ref(q, k, v, do, True, window)
    emu = ref.attention_bwd_tiled_ref(q, k, v, out, lse, do, True, window,
                                      products="3xtf32")
    tol = cs.BWD_TOL[torch.float32]
    rel, emu_rel = {}, {}
    for label, g, w, e in zip(("dq", "dk", "dv"), grads, want, emu):
        rel[label] = cs.check_rel("flash_attention_bwd", name, label, g, w,
                                  tol)[1]
        emu_rel[label] = cs.check_rel("flash_attention_bwd", name,
                                      f"{label} (emulation)", g, e, tol)[1]
    fns = dict(kernel=lambda: fops.flash_attention_bwd(
        q, k, v, out, lse, do, True, window))
    if with_library:
        lib = sdpa(window, S)
        qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        lib_out, doh = lib(qh, kh, vh), do.transpose(1, 2)
        fns.update(
            plain=lambda: kernels.attention_bwd_ref(q, k, v, do, True,
                                                    window),
            library=lambda: torch.autograd.grad(lib_out, (qh, kh, vh), doh,
                                                retain_graph=True))
    ms = cs.median_ms(fns, (), samples=3, inner=5)
    ms["kernel_cold"] = cs.cold_ms(
        lambda *a: fops.flash_attention_bwd(*a, True, window),
        cs.cold_copies((q, k, v, out, lse, do)), samples=3, inner=5)
    return dict(name=name, rel_err=rel, emulation_rel_err=emu_rel, **ms)


def main(names) -> int:
    if not torch.cuda.is_available():
        print("flash_f32_tiles: torch finds no CUDA device", file=sys.stderr)
        return 1
    import repro_torch.kernels as kernels
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref

    cs.log(cs.card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names = names or list(VARIANTS)
    libs, by_text = {}, {}   # variants with the same source share a build

    def library(path, declare):
        text = path.read_text()
        if text not in by_text:
            by_text[text] = nvcc.CudaLibrary(path, declare)
        return by_text[text]

    for name in names:
        if "=" in name:
            d = Path(name.split("=", 1)[1])
            src = {stem: d / f"{stem}.cu"
                   for stem in ("flash_attention", "flash_attention_bwd")}
        else:
            src = variant_sources(name, VARIANTS[name])
        libs[name] = (library(src["flash_attention"], fa._declare),
                      library(src["flash_attention_bwd"], fa._declare_bwd))
    t0 = time.perf_counter()
    nvcc.build_all(by_text.values())
    cs.log("build", json.dumps(dict(seconds=time.perf_counter() - t0)))
    failed = 0
    for i, name in enumerate(names):
        fwd, bwd = libs[name]
        fa.LIB, fa.BWD_LIB = fwd, bwd
        build = [r for lib in (fwd, bwd)
                 for r in cs.ptxas_summary(lib.build_log)
                 if "_f32" in r["entry"]]
        plans = {f"{kind}{hd}": fa.occupancy(hd, torch.float32,
                                             backward=kind == "bwd")
                 for kind in ("fwd", "bwd") for hd in (64, 128, 256)}
        cs.log("variant", name, json.dumps(dict(
            cfg={**BASE, **VARIANTS.get(name, {})}, build=build,
            plans=plans)))
        for row in FWD_ROWS:
            try:
                res = fwd_row(kernels, ref, row, with_library=i == 0)
            except Exception as e:  # noqa: BLE001 - report, go on
                failed += 1
                res = dict(name=row[0], error=repr(e)[:400])
            cs.log("fwd", name, json.dumps(res))
        for row in BWD_ROWS:
            try:
                res = bwd_row(kernels, fops, ref, row, with_library=i == 0)
            except Exception as e:  # noqa: BLE001 - report, go on
                failed += 1
                res = dict(name=row[0], error=repr(e)[:400])
            cs.log("bwd", name, json.dumps(res))
        torch.cuda.empty_cache()
    cs.log(cs.card_line())
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
