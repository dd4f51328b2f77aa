"""Loop-closure operating point: precision and recall of the LSH-BoW score
gates over generated scene sets, on the port's ``brief`` and ``bow`` (the
counterpart of ``scripts/bow_sweep.py``, with the same scenes from the same
rng and the same table).

A revisit is a scene re-rendered from a slightly shifted viewpoint with
photometric noise; an impostor is another scene of the same texture class
(sparse, medium, dense). A false loop rewrites the whole map while a missed
one costs drift, so the table gives, per gate, the recall of revisits and
the false-positive rate of impostors, and the check asks of the gate 0.30 a
false-positive rate ≤ 0.5 % on every texture and a recall ≥ 0.9 on medium
and dense scenes.

    python -m ground_fusion_tpu_torch.scripts.bow_sweep [--device cuda|cpu]
        [--scenes N] [--write-md PATH]

Exits with 1 when the gate fails its check. ``--write-md PATH`` writes the
table there (the JAX package's ``PARITY.md`` is its own record and is never
written).
"""

from __future__ import annotations

import sys

import numpy as np

GATES = (0.15, 0.20, 0.25, 0.30, 0.35, 0.45)
TEXTURES = ("sparse", "medium", "dense")
N_SCENES = 24
SHIPPED_GATE = 0.30


def make_scene(rng, texture: str, h=120, w=160):
    """Scene = a set of world 'landmarks' rendered as blobs/edges over noise;
    texture classes vary feature density + background structure."""
    img = rng.normal(40.0, 6.0, (h, w)).astype(np.float32)
    if texture == "sparse":
        n_blobs, amp = 25, 160.0
    elif texture == "medium":
        n_blobs, amp = 80, 140.0
    else:  # dense
        n_blobs, amp = 200, 120.0
        # structured background: bars
        for x0 in range(0, w, 24):
            img[:, x0:x0 + 3] += 40.0
    pts = rng.uniform([6, 6], [w - 6, h - 6], (n_blobs, 2))
    ys, xs = np.mgrid[0:7, 0:7] - 3
    blob = np.exp(-(xs ** 2 + ys ** 2) / 3.0)
    for (u, v) in pts:
        ui, vi = int(u), int(v)
        img[vi - 3: vi + 4, ui - 3: ui + 4] += amp * blob * rng.uniform(0.6, 1.0)
    return np.clip(img, 0, 255), pts


def rerender(rng, img, shift_px=3.0, noise=4.0):
    """Viewpoint-perturbed revisit: subpixel shift + photometric noise."""
    dx, dy = rng.uniform(-shift_px, shift_px, 2)
    ix, iy = int(round(dx)), int(round(dy))
    out = np.roll(np.roll(img, iy, axis=0), ix, axis=1)
    out = out + rng.normal(0, noise, out.shape)
    return np.clip(out, 0, 255).astype(np.float32)


def scores(device=None, n_scenes: int = N_SCENES, textures=TEXTURES) -> dict:
    """``{texture: (revisit scores [n], impostor scores [n·(n-1)])}`` from
    ``default_rng(7)``, scenes of each texture in turn; ``device=None``
    means the GPU."""
    import torch

    from .. import resolve_device
    from ..config import Config
    from ..global_layers.bow import KeyframeDatabase, bow_histogram, l1_scores, word_selector, words_of
    from ..global_layers.brief import brief_describe, brief_pattern, fast_detect

    dev = resolve_device(device)
    cfg = Config()
    sel = torch.as_tensor(word_selector(), device=dev)
    pa, pb = (torch.as_tensor(p, device=dev) for p in brief_pattern())

    def hist_of(img):
        img_t = torch.as_tensor(img, dtype=torch.float32, device=dev)
        pts, ok = fast_detect(img_t, cfg.loop.fast_threshold, cfg.loop.max_keypoints)
        return bow_histogram(words_of(brief_describe(img_t, pts, pa, pb), ok, sel))

    rng = np.random.default_rng(7)
    results = {}
    for texture in textures:
        scenes = [make_scene(rng, texture)[0] for _ in range(n_scenes)]
        hists = [hist_of(s) for s in scenes]
        revisit_hists = [hist_of(rerender(rng, s)) for s in scenes]
        db = KeyframeDatabase(capacity=64, device=dev)
        for h in hists:
            db.add(h)
        idf = db.idf()
        rev, imp = [], []
        for i, h in enumerate(revisit_hists):
            s = l1_scores(db.hists, db.valid, h, idf).cpu().numpy()
            rev.append(s[i])                          # true revisit
            imp.extend(np.delete(s[:n_scenes], i))    # impostors
        results[texture] = (np.asarray(rev), np.asarray(imp))
    return results


def table(results: dict):
    """(Markdown lines, {(texture, gate): (recall, FP rate)})."""
    lines = ["| texture | gate | recall (revisits ≥ gate) | FP rate (impostors ≥ gate) |",
             "|---|---|---|---|"]
    summary = {}
    for texture, (rev, imp) in results.items():
        for g in GATES:
            rec, fp = float((rev >= g).mean()), float((imp >= g).mean())
            lines.append(f"| {texture} | {g:.2f} | {rec:.2f} | {fp:.4f} |")
            summary[(texture, g)] = (rec, fp)
        lines.append(f"| {texture} | — | revisit median {np.median(rev):.2f} "
                     f"| impostor median {np.median(imp):.2f} |")
    return lines, summary


def gate_ok(summary: dict) -> bool:
    """The shipped gate's check: FP ≤ 0.5 % on every texture, recall ≥ 0.9
    on medium and dense scenes."""
    textures = {t for t, _ in summary}
    return (all(summary[(t, SHIPPED_GATE)][1] <= 0.005 for t in textures)
            and all(summary[(t, SHIPPED_GATE)][0] >= 0.9
                    for t in ("medium", "dense") if t in textures))


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--scenes", type=int, default=N_SCENES)
    ap.add_argument("--write-md", default=None)
    args = ap.parse_args(argv)
    lines, summary = table(scores(args.device, args.scenes))
    print("\n".join(lines))
    ok = gate_ok(summary)
    print(f"\ngate {SHIPPED_GATE}: "
          f"{'OK (FP<=0.5% everywhere, recall>=0.9 on medium/dense)' if ok else 'REVIEW'}")
    if args.write_md:
        with open(args.write_md, "w") as fp:
            fp.write("# Loop-closure operating point of the port (LSH BoW gate sweep)\n\n"
                     "Written by `python -m ground_fusion_tpu_torch.scripts.bow_sweep`: "
                     f"{args.scenes} scenes per texture, rng 7.\n\n" + "\n".join(lines) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
