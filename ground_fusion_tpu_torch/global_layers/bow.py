"""Bag-of-binary-words place recognition as dense device math.

Replaces DBoW2's k=10/L=6 vocabulary-tree query (``dense_map/src/
ThirdParty/DBoW``, ``pose_graph.cpp:432-512`` detectLoop) with an LSH
word quantizer + one dense score computation over the whole keyframe
database: word id = selected descriptor bit positions (the tree's only job is
descriptor→word quantization; a bit-select hash is the branch-free analog),
TF-IDF-weighted L1 scoring identical to DBoW2's ``L1Scoring``
(s = 1 − ½‖v₁̂ − v₂̂‖₁), computed for all N stored keyframes in one shot.
The database tables live on the device; the gate logic stays on the host.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from .. import resolve_device
from ..ops.cuda.hamming import words_u32


def word_selector(n_word_bits: int = 12, n_desc_bits: int = 256, seed: int = 11):
    """Fixed bit positions defining the word hash (word space W = 2^bits)."""
    rng = np.random.default_rng(seed)
    return rng.choice(n_desc_bits, size=n_word_bits, replace=False).astype(np.int32)


def words_of(desc_packed: Tensor, ok: Tensor, sel: Tensor, n_word_bits: int = 12) -> Tensor:
    """Packed ``[K,8]`` int32 descriptors → word ids [K] (invalid → -1)."""
    sel = sel.to(torch.int64)
    bits = (words_u32(desc_packed)[:, sel // 32] >> (sel % 32)[None, :]) & 1   # [K, nbits]
    weights = 2 ** torch.arange(n_word_bits, device=desc_packed.device)
    w = torch.sum(bits * weights[None, :], dim=-1)
    return torch.where(ok, w, torch.full_like(w, -1)).to(torch.int32)


def bow_histogram(words: Tensor, n_words: int = 4096) -> Tensor:
    """Word ids → L1-normalized term-frequency histogram [W] (float32)."""
    ok = words >= 0
    idx = torch.where(ok, words, torch.zeros_like(words)).to(torch.int64)
    hist = torch.zeros(n_words, dtype=torch.float32, device=words.device)
    hist = hist.index_add(0, idx, ok.to(torch.float32))
    return hist / torch.clamp(torch.sum(hist), min=1.0)


def l1_scores(db_hists: Tensor, db_valid: Tensor, query: Tensor, idf: Tensor) -> Tensor:
    """DBoW2 L1 score of `query` against every stored keyframe:
    s = 1 − ½‖v̂_q − v̂_d‖₁ with TF-IDF weighting (TemplatedVocabulary
    L1Scoring). Returns [N] scores (0 where slot empty)."""
    qw = query * idf
    qw = qw / torch.clamp(torch.sum(torch.abs(qw)), min=1e-12)
    dw = db_hists * idf[None, :]
    dw = dw / torch.clamp(torch.sum(torch.abs(dw), dim=1, keepdim=True), min=1e-12)
    s = 1.0 - 0.5 * torch.sum(torch.abs(dw - qw[None, :]), dim=1)
    return torch.where(db_valid, s, torch.zeros_like(s))


def gated_candidate(scores: np.ndarray, kf_idx: np.ndarray, cur_index: int, min_gap: int,
                    score_best: float, score_min: float) -> int:
    """The detectLoop gate (pose_graph.cpp:476-508): skip keyframes within
    ``min_gap`` of ``cur_index``, take DBoW2's top 4 (``query(..., 4)``),
    require best score > ``score_best`` and candidates > ``score_min``; the
    earliest candidate KEYFRAME INDEX wins, or -1."""
    recent = kf_idx > cur_index - min_gap
    scores_g = np.where(recent, 0.0, scores)
    top4 = np.argsort(-scores_g)[:4]
    if scores_g[top4[0]] <= score_best:
        return -1
    cands = [int(kf_idx[i]) for i in top4 if scores_g[i] > score_min]
    return min(cands) if cands else -1


class KeyframeDatabase:
    """Growable BoW database (host wrapper over device tensors) — the DBoW2
    ``db.query(..., 4, frame_index-50)`` + gate logic of
    ``PoseGraph::detectLoop`` (pose_graph.cpp:432-512).

    Like the reference's DBoW2 database, it is unbounded: ``capacity`` is
    only the initial allocation and the device tables double when full. Each
    slot records the KEYFRAME index it holds, so ``query`` gates the
    ``min_gap`` window and returns candidates by keyframe index. Memory:
    [N, n_words] f32 histograms (≈16 MB per 1000 keyframes at W=4096).
    ``device=None`` means the GPU and raises when there is none."""

    def __init__(self, capacity: int = 512, n_words: int = 4096,
                 score_best: float = 0.05, score_min: float = 0.015,
                 min_gap: int = 50, device=None):
        self.capacity = capacity
        self.n_words = n_words
        self.score_best = score_best
        self.score_min = score_min
        self.min_gap = min_gap
        self.device = resolve_device(device)
        self.hists = torch.zeros((capacity, n_words), dtype=torch.float32, device=self.device)
        self.valid = torch.zeros((capacity,), dtype=torch.bool, device=self.device)
        self.kf_idx = np.full(capacity, -1, np.int64)
        self.doc_freq = np.zeros(n_words, np.float64)
        self.count = 0

    def idf(self) -> Tensor:
        n = max(self.count, 1)
        return torch.as_tensor(
            np.log(np.maximum(n / np.maximum(self.doc_freq, 1.0), 1.0)) + 1.0,
            dtype=torch.float32, device=self.device)

    def _grow(self) -> None:
        """Double the device tables (the unbounded-database growth path)."""
        self.hists = torch.cat([self.hists, torch.zeros_like(self.hists)])
        self.valid = torch.cat([self.valid, torch.zeros_like(self.valid)])
        self.kf_idx = np.concatenate([self.kf_idx, np.full(self.capacity, -1, np.int64)])
        self.capacity *= 2

    def add(self, hist: Tensor, kf_index: int | None = None) -> int:
        """Register a keyframe histogram under ``kf_index`` (defaults to the
        insertion count — correct when every keyframe is added in order).
        Returns the storage slot."""
        if self.count == self.capacity:
            self._grow()
        i = self.count
        hist = torch.as_tensor(hist, dtype=torch.float32, device=self.device)
        self.hists[i] = hist
        self.valid[i] = True
        self.kf_idx[i] = self.count if kf_index is None else int(kf_index)
        self.doc_freq += (hist > 0).cpu().numpy()
        self.count += 1
        return i

    def query(self, hist: Tensor, cur_index: int):
        """Earliest candidate KEYFRAME INDEX passing the two-threshold gate,
        or -1 (:func:`gated_candidate`)."""
        if self.count == 0:
            return -1
        hist = torch.as_tensor(hist, dtype=torch.float32, device=self.device)
        scores = l1_scores(self.hists, self.valid, hist, self.idf()).cpu().numpy()
        return gated_candidate(scores, self.kf_idx, cur_index, self.min_gap,
                               self.score_best, self.score_min)
