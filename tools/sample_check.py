#!/usr/bin/env python3
"""Holds kernel I (the matcher's per-pair statistics and hypothesis
sampling, ``csrc/sample.cu``) to its plain twin, ``matching.ransac.
_pair_stats`` followed by ``sample_hypotheses``, on one GPU, bit for bit.

    python3 tools/sample_check.py

Both run on the same card inputs: the templates of ``tools/finish_check.py``
(``utils.synthetic.users_gallery`` with their slots shuffled; genuine
mates, impostors, an all-invalid B row, an A with 5 valid minutiae, doubled
minutiae, an A ring about a B cluster), with more special rows where P
holds them: an all-invalid A row, no same-type B candidate (has_cand 0), a
spatial-std reject (B spread three times as wide), tied weights (every
quality 0.5), types 2 and 3 (a type with its own B scan) and a template
with 3 valid minutiae.

Cases: seeds 0, 1, 2 x P in {1, 3, 40, 512, 1024, 2048, 4050, 4096} x K in
{32, 64, 128} x (H = 300; H = 32 with ``full_iters`` 300) x ``use_type``
on and off; and uniforms with u * total rounding up to the total (u the
largest float below 1) and u = 0, at K = 64. Every output (wa, wb, na,
nb, possible, reject, theta, t, has_cand) must be bit-equal. Then kernel
I's scans against ``torch.cumsum`` at the row counts of those calls (P and
P H) for K in {32, 64, 128}, every row bit-equal; one
``match_pairs_batch`` call must add exactly 1 to ``kernel.sample``; a
second call must make no synchronising CUDA call
(``torch.cuda.set_sync_debug_mode("error")``); and
``parallel.gallery.identify`` must give the plain route's scores. Exits 1
on any failure. The card tests of ``tests/test_torch_matching.py`` run the
same functions.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SEEDS = (0, 1, 2)
PAIRS = (1, 3, 40, 512, 1024, 2048, 4050, 4096)
KS = (32, 64, 128)
HYPS = ((300, 0), (32, 300))          # (ransac_iter, full_iters)
SCAN_ROWS = sorted({*PAIRS, *(pn * h for pn in PAIRS for h, _ in HYPS)})
OUTPUTS = ("wa", "wb", "na", "nb", "possible", "reject", "theta", "t",
           "has_cand")


def _finish_tool():
    path = Path(__file__).resolve().parent / "finish_check.py"
    spec = importlib.util.spec_from_file_location("finish_check", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def templates(seed: int, pnum: int, k: int):
    """(P, K) numpy templates A and B: ``finish_check.templates``, then
    from row 4 on every 16th row from rows 4 to 7, 10 and 11 made special
    (see the module)."""
    a, b = _finish_tool().templates(seed, pnum, k)
    g = np.random.default_rng(2000 + seed)
    special = {4: "no A", 5: "no candidate", 6: "spread", 7: "ties",
               10: "types", 11: "few"}
    for first, what in special.items():
        for r in range(first, pnum, 16):
            if what == "no A":                   # a padded A row
                for v in a.values():
                    v[r] = 0
            elif what == "no candidate":         # A all endings, B all forks
                a["minutia_type"][r] = 0
                b["minutia_type"][r] = 1
            elif what == "spread":               # B three times as wide
                c = b["xy"][r][b["valid"][r]].mean(axis=0)
                b["xy"][r] = (c + 3 * (b["xy"][r] - c)).astype(np.float32)
            elif what == "ties":                 # equal weights
                for ms in (a, b):
                    for f in ("quality", "coherence", "angular_stability"):
                        ms[f][r] = 0.5
            elif what == "types":                # a type of its own scan
                for ms in (a, b):
                    ms["minutia_type"][r] = g.integers(0, 4, k)
            elif what == "few":                  # 3 valid minutiae
                a["valid"][r] &= np.cumsum(a["valid"][r]) <= 3
    return a, b


def plain(a, b, p, u=None):
    """The plain route on ``a``'s device: ``_pair_stats`` then
    ``sample_hypotheses``."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching.ransac import (
        _pair_stats, sample_hypotheses)
    stats = _pair_stats(a, b)
    return (*stats, *sample_hypotheses(a, b, stats[0], stats[1], p, u))


def kernel(a, b, p, u=None):
    """Kernel I through its wrapper; ``u``, if given, in place of the
    cached uniforms of ``p`` for this call."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching import (
        cuda_match as cm)
    if u is None:
        return cm.sample_pairs_cuda(a, b, p)
    key = (p.seed, p.ransac_iter, p.full_iters, a.xy.device)
    kept = cm._UNIFORMS.get(key)
    cm._UNIFORMS[key] = u.to(a.xy.device)
    try:
        return cm.sample_pairs_cuda(a, b, p)
    finally:
        if kept is None:
            del cm._UNIFORMS[key]
        else:
            cm._UNIFORMS[key] = kept


def compare(a, b, p, u=None) -> dict:
    """Kernel I and the plain route on the same inputs: how many elements
    of each output differ in their bits, and a few counts of what the
    inputs exercised."""
    import torch
    got = kernel(a, b, p, u)
    want = plain(a, b, p, u)
    torch.cuda.synchronize()
    out = dict(pairs=int(a.valid.shape[0]),
               rejected=int(want[5].sum()),
               no_candidate=int((want[8] == 0).sum()))
    for name, x, y in zip(OUTPUTS, got, want):
        if x.dtype != y.dtype or x.shape != y.shape:
            out[name + "_differ"] = -1
            continue
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        out[name + "_differ"] = int((x != y).sum())
    return out


def ok(r: dict) -> bool:
    return all(r[name + "_differ"] == 0 for name in OUTPUTS)


def case(seed: int, pnum: int, k: int, hyps: tuple, use_type: bool,
         dev) -> dict:
    from multimodal_biometric_fingerprints_palms_tpu_torch.features.minutiae import (
        minutiae_from_numpy)
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching.ransac import (
        MatchParams)
    a_np, b_np = templates(seed, pnum, k)
    a, b = minutiae_from_numpy(a_np, dev), minutiae_from_numpy(b_np, dev)
    p = MatchParams(ransac_iter=hyps[0], full_iters=hyps[1],
                    use_type=use_type)
    return compare(a, b, p)


def edge_uniforms(seed: int, pnum: int, dev) -> dict:
    """Uniforms at the ends of [0, 1): the largest float below 1 (u * total
    rounds up to the total for most totals), 0, and random ones between."""
    import torch
    from multimodal_biometric_fingerprints_palms_tpu_torch.features.minutiae import (
        minutiae_from_numpy)
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching.ransac import (
        MatchParams)
    g = np.random.default_rng(3000 + seed)
    u = g.random((64, 2)).astype(np.float32)
    u[0::3] = np.nextafter(np.float32(1), np.float32(0))
    u[1::3, 0] = 0.0
    u[2::6, 1] = 0.0
    a_np, b_np = templates(seed, pnum, 64)
    a, b = minutiae_from_numpy(a_np, dev), minutiae_from_numpy(b_np, dev)
    return compare(a, b, MatchParams(ransac_iter=64), torch.from_numpy(u))


def scan_check(rows: int, k: int, dev, seed: int = 0) -> int:
    """Rows of kernel I's scan (``mbfp_scan_rows`` at the chunk
    ``cumsum_chunk`` gives) that differ from ``torch.cumsum`` of a (rows,
    k) float32 tensor of weights on the card."""
    import torch
    from multimodal_biometric_fingerprints_palms_tpu_torch.kernels import build
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching import (
        cuda_match as cm)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.rand((rows, k), generator=g, device=dev)
         * torch.exp2(torch.randint(-6, 7, (rows, k), generator=g,
                                    device=dev).float()))
    x = torch.where(torch.rand((rows, k), generator=g, device=dev) < 0.2,
                    0.0, x)
    out = torch.empty_like(x)
    rc = build.load_library().mbfp_scan_rows(
        x.data_ptr(), out.data_ptr(), rows, k, cm.cumsum_chunk(rows, k),
        build.current_stream(x))
    build.check(rc, "mbfp_scan_rows")
    want = torch.cumsum(x, dim=-1)
    return int((out.view(torch.int32) != want.view(torch.int32))
               .any(dim=-1).sum())


def launches_per_call(dev) -> dict:
    """Each kernel's launches in one ``match_pairs_batch`` call."""
    import torch
    from multimodal_biometric_fingerprints_palms_tpu_torch.features.minutiae import (
        minutiae_from_numpy)
    from multimodal_biometric_fingerprints_palms_tpu_torch.kernels import build
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching import (
        cuda_match as cm)
    a, b = (minutiae_from_numpy(x, dev) for x in templates(0, 64, 64))
    before = build.launches()
    cm.match_pairs_batch(a, b)
    torch.cuda.synchronize()
    return {n: c - before[n] for n, c in build.launches().items()
            if c != before[n]}


def second_call_syncs(dev) -> str:
    """'' when a second ``match_pairs_batch`` call (the first warms the
    library and the uniforms) makes no synchronising CUDA call, else the
    error ``torch.cuda.set_sync_debug_mode("error")`` raised."""
    import torch
    from multimodal_biometric_fingerprints_palms_tpu_torch.features.minutiae import (
        minutiae_from_numpy)
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching import (
        cuda_match as cm)
    a, b = (minutiae_from_numpy(x, dev) for x in templates(1, 1024, 64))
    cm.match_pairs_batch(a, b)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cm.match_pairs_batch(a, b)
    except RuntimeError as e:
        return str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return ""


def identify_against_plain(dev, chunk: int = 1024) -> dict:
    """``parallel.gallery.identify`` of a few probes over a padded gallery
    of 2,000 templates, through kernel I and through the plain route on
    the card."""
    import torch
    from multimodal_biometric_fingerprints_palms_tpu_torch.features.minutiae import (
        MinutiaeSet, minutiae_from_numpy)
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching import (
        cuda_match as cm)
    from multimodal_biometric_fingerprints_palms_tpu_torch.parallel import gallery
    from multimodal_biometric_fingerprints_palms_tpu_torch.parallel.mesh import (
        create_mesh)
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (
        users_gallery)
    tm = minutiae_from_numpy(users_gallery(1000, 2, seed=5), dev)
    enrolled = gallery.pad_gallery(MinutiaeSet(*(x[0::2] for x in tm)), chunk)
    probes = MinutiaeSet(*(x[1::2] for x in tm))
    mesh = create_mesh()
    rows = (0, 17, 999)

    def run():
        return torch.stack([gallery.identify(
            MinutiaeSet(*(x[i] for x in probes)), enrolled, mesh,
            chunk=chunk) for i in rows])

    got = run()
    shipped = cm.sample_pairs
    cm.sample_pairs = plain
    try:
        want = run()
    finally:
        cm.sample_pairs = shipped
    torch.cuda.synchronize()
    return dict(scores=int(got.numel()),
                differ=int((got.view(torch.int32)
                            != want.view(torch.int32)).sum()),
                mates_top1=sum(int(got[j].argmax()) == i
                               for j, i in enumerate(rows)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card")
        return 1
    dev = torch.device("cuda")
    failed = 0
    total = {}
    runs = [(s, pn, k, hy, ut) for k in KS for hy in HYPS
            for ut in (True, False) for s in SEEDS for pn in PAIRS]
    for s, pn, k, hy, ut in runs:
        r = case(s, pn, k, hy, ut, dev)
        good = ok(r)
        failed += not good
        for key, v in r.items():
            total[key] = total.get(key, 0) + v
        if not good or (pn >= 4050 and s == 0):
            print(f"seed {s} P={pn} K={k} H={hy[0]} full_iters={hy[1]} "
                  f"use_type={ut}: " + ", ".join(f"{key} {v}"
                                                  for key, v in r.items())
                  + ("" if good else "  FAILED"))
    print(f"{len(runs)} cases, {failed} failed; summed over them: "
          + ", ".join(f"{key} {v}" for key, v in total.items()))
    for s in SEEDS:
        for pn in (1, 40, 1024):
            r = edge_uniforms(s, pn, dev)
            good = ok(r)
            failed += not good
            print(f"edge uniforms seed {s} P={pn}: {r}"
                  + ("" if good else "  FAILED"))
    bad_scans = {}
    for k in KS:
        for rows in SCAN_ROWS:
            n = scan_check(rows, k, dev)
            if n:
                bad_scans[(rows, k)] = n
    print(f"scans against torch.cumsum: {len(SCAN_ROWS) * len(KS)} shapes "
          f"(rows {SCAN_ROWS[0]} to {SCAN_ROWS[-1]}, K {KS}); rows that "
          f"differ: {bad_scans or 'none'}")
    failed += len(bad_scans)
    n = launches_per_call(dev)
    print(f"launches of one match_pairs_batch call: {n}")
    failed += n != {"sample": 1, "match": 1, "finish": 1}
    sync = second_call_syncs(dev)
    print(f"second match_pairs_batch call under sync debug mode 'error': "
          f"{sync or 'no synchronising call'}")
    failed += bool(sync)
    ident = identify_against_plain(dev)
    print(f"identify through I against the plain route: {ident}")
    failed += ident["differ"] != 0 or ident["mates_top1"] != 3
    print("ok" if not failed else f"{failed} failures")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
