"""DBoW2 binary-vocabulary import: load the reference's trained
``support_files/brief_k10L6.bin`` and run its tree quantization + TF-IDF L1
scoring as device math.

Why this exists: the LSH quantizer (:mod:`.bow`) is a redesign whose score
populations — and therefore loop gates — differ from DBoW2's. For parity runs
on real data the operating point must be comparable to the reference's
(``pose_graph.cpp:476-480`` gates 0.05/0.015 against the trained k=10/L=6
vocabulary), so this module loads that exact artifact.

Binary layout (VocabularyBinary.{hpp,cpp} — the VINS fork's own serializer):
``int32 k, L, scoringType, weightingType, nNodes, nWords`` then ``nNodes`` ×
``{int32 nodeId, int32 parentId, float64 weight, uint64 descriptor[4]}``
(48 bytes, no padding) then ``nWords`` × ``{int32 nodeId, int32 wordId}``.
Node ids are 1-based into a tree whose root is node 0 and is NOT serialized
(TemplatedVocabulary::loadBin).

Quantization (TemplatedVocabulary::transform): from the root, descend L
levels picking the child with minimum Hamming distance; the leaf's word id +
trained weight form the (word, tf·weight) BoW entry. Here the walk is
branch-free and batched over all descriptors: a padded ``children[node, k]``
table + one XOR-popcount per level (the plain SWAR popcount of
``ops/cuda/hamming.py``).

Scoring: DBoW2 ``L1Scoring`` over L1-normalized TF-IDF vectors reduces to
``s = Σ_{common words} min(q_w, d_w)``; with ~1e6 leaf words the vectors are
sparse, so keyframes store sorted (word, weight) arrays and the
query-vs-all-N score is a batched ``searchsorted`` intersection.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from .. import resolve_device
from ..ops.cuda.hamming import popcount32, words_u32
from .bow import gated_candidate

_HDR = np.dtype([("k", "<i4"), ("L", "<i4"), ("scoring", "<i4"),
                 ("weighting", "<i4"), ("n_nodes", "<i4"), ("n_words", "<i4")])
_NODE = np.dtype([("node_id", "<i4"), ("parent_id", "<i4"),
                  ("weight", "<f8"), ("desc", "<u8", (4,))])
_WORD = np.dtype([("node_id", "<i4"), ("word_id", "<i4")])
_INT32_MAX = np.iinfo(np.int32).max


class DBoW2Vocabulary:
    """Parsed vocabulary tree with device tables for quantization.
    ``device=None`` means the GPU and raises when there is none."""

    def __init__(self, k: int, L: int, children: np.ndarray,
                 node_desc: np.ndarray, node_word: np.ndarray,
                 node_weight: np.ndarray, n_words: int, device=None):
        self.k = k
        self.L = L
        self.n_words = n_words
        dev = resolve_device(device)
        # device tables (children padded with -1, masked by child_valid)
        self.children = torch.as_tensor(children.astype(np.int64), device=dev)       # [N, k]
        self.child_valid = self.children >= 0
        self.desc_packed = torch.as_tensor(
            np.ascontiguousarray(node_desc, np.uint32).view(np.int32), device=dev)  # [N, 8]
        self.node_word = torch.as_tensor(node_word.astype(np.int32), device=dev)     # [N] (-1 inner)
        self.node_weight = torch.as_tensor(node_weight, dtype=torch.float32, device=dev)

    # -- io ----------------------------------------------------------------

    @classmethod
    def load_binary(cls, path: str, device=None) -> "DBoW2Vocabulary":
        with open(path, "rb") as fp:
            hdr = np.frombuffer(fp.read(_HDR.itemsize), _HDR)[0]
            nodes = np.frombuffer(fp.read(_NODE.itemsize * int(hdr["n_nodes"])), _NODE)
            words = np.frombuffer(fp.read(_WORD.itemsize * int(hdr["n_words"])), _WORD)
        n = int(nodes["node_id"].max()) + 1 if len(nodes) else 1
        k = int(hdr["k"])
        children = np.full((n, k), -1, np.int32)
        child_count = np.zeros(n, np.int32)
        node_desc = np.zeros((n, 8), np.uint32)
        node_weight = np.zeros(n, np.float64)
        for rec in nodes:
            nid, pid = int(rec["node_id"]), int(rec["parent_id"])
            children[pid, child_count[pid]] = nid
            child_count[pid] += 1
            node_desc[nid] = rec["desc"].view(np.uint32)
            node_weight[nid] = rec["weight"]
        node_word = np.full(n, -1, np.int32)
        node_word[words["node_id"]] = words["word_id"]
        return cls(k, int(hdr["L"]), children, node_desc, node_word,
                   node_weight, int(hdr["n_words"]), device=device)

    @staticmethod
    def save_binary(path: str, k: int, L: int, children: np.ndarray,
                    node_desc: np.ndarray, node_word: np.ndarray,
                    node_weight: np.ndarray) -> None:
        """Write the VINSLoop binary format (round-trip testing; also lets a
        user export a self-trained vocabulary for the reference stack)."""
        n = children.shape[0]
        recs, words = [], []
        for pid in range(n):
            for c in children[pid]:
                if c < 0:
                    continue
                recs.append((c, pid, float(node_weight[c]), node_desc[c].view(np.uint64)))
                if node_word[c] >= 0:
                    words.append((c, int(node_word[c])))
        nodes = np.array(recs, _NODE)
        warr = np.array(words, _WORD)
        hdr = np.array([(k, L, 0, 0, len(nodes), len(warr))], _HDR)
        with open(path, "wb") as fp:
            fp.write(hdr.tobytes())
            fp.write(nodes.tobytes())
            fp.write(warr.tobytes())

    # -- quantization ------------------------------------------------------

    def quantize(self, desc_packed: Tensor, ok: Tensor):
        """Descriptors ``[K,8]`` int32 words → (word ids [K] int32 (-1
        invalid), weights [K] f32) via the L-level Hamming tree walk."""
        return _tree_quantize(self.children, self.child_valid, self.desc_packed,
                              self.node_word, self.node_weight, desc_packed, ok, self.L)


def _tree_quantize(children, child_valid, node_desc, node_word, node_weight,
                   desc, ok, L: int):
    """All descriptors walk the tree together: per level one gather of the
    current nodes' children and one XOR-popcount against them."""
    d = words_u32(desc)                                     # [K, 8]
    node_u = words_u32(node_desc)                           # [N, 8]
    cur = torch.zeros(desc.shape[0], dtype=torch.int64, device=desc.device)
    big = torch.iinfo(torch.int64).max
    for _ in range(L):
        cand = children[cur]                                # [K, k]
        valid = child_valid[cur]
        x = node_u[torch.clamp(cand, min=0)] ^ d[:, None, :]
        dist = popcount32(x).sum(dim=-1)                    # [K, k]
        dist = torch.where(valid, dist, torch.full_like(dist, big))
        nxt = torch.gather(cand, 1, torch.argmin(dist, dim=1, keepdim=True))[:, 0]
        # ragged trees: stop at leaves (no valid children)
        cur = torch.where(valid.any(dim=1), nxt, cur)
    wid, wt = node_word[cur], node_weight[cur]
    return (torch.where(ok, wid, torch.full_like(wid, -1)),
            torch.where(ok, wt, torch.zeros_like(wt)))


def sparse_l1_scores(db_words: Tensor, db_w: Tensor, db_valid: Tensor,
                     q_words: Tensor, q_w: Tensor) -> Tensor:
    """DBoW2 L1 score of the query against every stored keyframe:
    ``s = Σ_{common} min(q, d)`` over L1-normalized TF-IDF vectors.
    ``db_words`` [N,K] sorted int32 (pad INT32_MAX), ``db_w`` [N,K] f32;
    ``q_words`` [K] sorted, ``q_w`` [K]."""
    n, k = db_words.shape
    q = q_words[None, :].expand(n, q_words.shape[0]).contiguous()
    idx = torch.clamp(torch.searchsorted(db_words, q), 0, k - 1)
    hit = torch.gather(db_words, 1, idx) == q
    common = torch.minimum(torch.gather(db_w, 1, idx), q_w[None, :])
    s = torch.sum(torch.where(hit, common, torch.zeros_like(common)), dim=1)
    return torch.where(db_valid, s, torch.zeros_like(s))


def _bow_vector(word_ids: np.ndarray, weights: np.ndarray, pad_to: int):
    """(sorted unique words, tf·weight L1-normalized), padded."""
    ok = word_ids >= 0
    wid = word_ids[ok]
    wt = weights[ok]
    uniq, inv = np.unique(wid, return_inverse=True)
    acc = np.zeros(len(uniq))
    np.add.at(acc, inv, wt)                    # tf × trained idf weight
    norm = acc.sum()
    if norm > 0:
        acc = acc / norm
    out_w = np.full(pad_to, _INT32_MAX, np.int32)
    out_v = np.zeros(pad_to, np.float32)
    m = min(len(uniq), pad_to)
    out_w[:m] = uniq[:m]
    out_v[:m] = acc[:m]
    return out_w, out_v


class SparseBowDatabase:
    """Keyframe database over DBoW2-quantized sparse BoW vectors — the same
    gate semantics as :class:`.bow.KeyframeDatabase` (top-4, best > 0.05,
    candidates > 0.015, 50-frame gap, earliest wins; pose_graph.cpp:432-512)
    at the reference's trained operating point. Tables on the vocabulary's
    device; the gate on the host."""

    def __init__(self, vocab: DBoW2Vocabulary, capacity: int = 512,
                 max_words_per_kf: int = 512, score_best: float = 0.05,
                 score_min: float = 0.015, min_gap: int = 50):
        self.vocab = vocab
        self.capacity = capacity
        self.K = max_words_per_kf
        self.score_best = score_best
        self.score_min = score_min
        self.min_gap = min_gap
        self.device = vocab.children.device
        self.db_words = torch.full((capacity, self.K), _INT32_MAX, dtype=torch.int32,
                                   device=self.device)
        self.db_w = torch.zeros((capacity, self.K), dtype=torch.float32, device=self.device)
        self.valid = torch.zeros((capacity,), dtype=torch.bool, device=self.device)
        self.kf_idx = np.full(capacity, -1, np.int64)
        self.count = 0

    def bow_vector(self, desc_packed: np.ndarray, ok: np.ndarray):
        """Host descriptors (``[K,8]`` uint32 words) → the padded sparse
        vector (words, weights) as numpy."""
        desc = torch.as_tensor(np.ascontiguousarray(desc_packed, np.uint32).view(np.int32),
                               device=self.device)
        wid, wt = self.vocab.quantize(desc, torch.as_tensor(ok, device=self.device))
        return _bow_vector(wid.cpu().numpy(), wt.cpu().numpy(), self.K)

    def _grow(self):
        self.db_words = torch.cat([self.db_words, torch.full_like(self.db_words, _INT32_MAX)])
        self.db_w = torch.cat([self.db_w, torch.zeros_like(self.db_w)])
        self.valid = torch.cat([self.valid, torch.zeros_like(self.valid)])
        self.kf_idx = np.concatenate([self.kf_idx, np.full(self.capacity, -1, np.int64)])
        self.capacity *= 2

    def add(self, vec, kf_index: int | None = None) -> int:
        words, w = vec
        if self.count == self.capacity:
            self._grow()
        i = self.count
        self.db_words[i] = torch.as_tensor(words, dtype=torch.int32, device=self.device)
        self.db_w[i] = torch.as_tensor(w, dtype=torch.float32, device=self.device)
        self.valid[i] = True
        self.kf_idx[i] = self.count if kf_index is None else int(kf_index)
        self.count += 1
        return i

    def query(self, vec, cur_index: int) -> int:
        if self.count == 0:
            return -1
        words, w = vec
        scores = sparse_l1_scores(
            self.db_words, self.db_w, self.valid,
            torch.as_tensor(words, dtype=torch.int32, device=self.device),
            torch.as_tensor(w, dtype=torch.float32, device=self.device)).cpu().numpy()
        return gated_candidate(scores, self.kf_idx, cur_index, self.min_gap,
                               self.score_best, self.score_min)
