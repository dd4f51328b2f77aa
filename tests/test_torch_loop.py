"""PyTorch port vs JAX package: FAST, BRIEF, descriptor matching, the BoW and
DBoW2 place-recognition databases and the RANSAC PnP of loop closure, on the
same numpy-seeded inputs (the port on the CPU, the JAX package on the CPU in
float64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)      # small tensors; leave the cores to the other test workers

from ground_fusion_tpu.geometry.so3 import mat_to_quat, ypr_to_mat
from ground_fusion_tpu.global_layers import bow as jbow
from ground_fusion_tpu.global_layers import brief as jbrief
from ground_fusion_tpu.global_layers import dbow_vocab as jdbow
from ground_fusion_tpu.global_layers import pnp as jpnp
from ground_fusion_tpu_torch.global_layers import bow as tbow
from ground_fusion_tpu_torch.global_layers import brief as tbrief
from ground_fusion_tpu_torch.global_layers import dbow_vocab as tdbow
from ground_fusion_tpu_torch.global_layers import pnp as tpnp
from test_dbow_vocab import _make_synthetic_vocab
from test_global_layers import _texture


def _image(seed):
    """An integer-valued 120x160 texture (sums of pixels are then exact in
    any order, so FAST's scores are too)."""
    return np.round(_texture(seed=seed))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _i32(d) -> torch.Tensor:
    return torch.as_tensor(np.asarray(d, np.uint32).view(np.int32))


@pytest.fixture(scope="module")
def pattern():
    pa, pb = jbrief.brief_pattern()
    return pa, pb


@pytest.mark.parametrize("seed", [2, 4])
def test_fast_same_scores_points_and_order(seed):
    img = _image(seed)
    j_img, t_img = jnp.asarray(img, jnp.float32), torch.as_tensor(img, dtype=torch.float32)
    assert np.array_equal(np.asarray(jax.jit(jbrief.fast_score)(j_img)),
                          tbrief.fast_score(t_img).numpy())
    j_pts, j_ok = jbrief.fast_detect(j_img, 20.0, 500)
    t_pts, t_ok = tbrief.fast_detect(t_img, 20.0, 500)
    assert np.array_equal(np.asarray(j_pts), t_pts.numpy())
    assert np.array_equal(np.asarray(j_ok), t_ok.numpy())
    assert int(t_ok.sum()) > 30 and not bool(t_ok.all())    # ties among -inf were ordered too
    # the stable order makes a shorter list the head of the longer one
    s_pts, s_ok = tbrief.fast_detect(t_img, 20.0, 64)
    assert torch.equal(s_pts, t_pts[:64]) and torch.equal(s_ok, t_ok[:64])


def test_brief_same_descriptors_up_to_rounding_ties(pattern):
    """Equal descriptors, except bits whose two blurred samples are equal to
    rounding in the port (XLA sums the 9 taps of the blur in another order,
    so two equal window sums can differ by an ulp there)."""
    pa, pb = pattern
    img = _image(3)
    rng = np.random.default_rng(0)
    pts, _ = jbrief.fast_detect(jnp.asarray(img, jnp.float32), 20.0, 200)
    pts = np.concatenate([np.asarray(pts, np.float64),
                          rng.uniform([-5, -5], [165, 125], (60, 2))])   # sub-pixel, off the image
    want = np.asarray(jbrief.brief_describe(jnp.asarray(img), jnp.asarray(pts),
                                            jnp.asarray(pa, jnp.float64), jnp.asarray(pb, jnp.float64)))
    want = want.astype(np.uint32)          # x64 JAX sums the words into uint64
    t_args = (torch.as_tensor(img), torch.as_tensor(pts), torch.as_tensor(pa, dtype=torch.float64),
              torch.as_tensor(pb, dtype=torch.float64))
    got = _u32(tbrief.brief_describe(*t_args))
    ia, ib = (s.numpy() for s in tbrief.brief_samples(*t_args))
    diff = np.unpackbits((want ^ got).view(np.uint8), bitorder="little").reshape(len(pts), 256)
    tie = np.abs(ia - ib) <= 1e-9 * np.maximum(np.abs(ia), 1.0)
    assert not np.any(diff.astype(bool) & ~tie)
    assert diff.sum() <= 0.01 * diff.size


def test_match_brief_same_indices_and_gate(pattern):
    pa, pb = pattern
    img = _image(2)
    j_img = jnp.asarray(img, jnp.float32)
    pts, ok = jbrief.fast_detect(j_img, 20.0, 128)
    desc = np.asarray(jbrief.brief_describe(j_img, pts, jnp.asarray(pa), jnp.asarray(pb)))
    img2 = np.roll(img, (2, 4), (0, 1))
    desc2 = np.asarray(jbrief.brief_describe(jnp.asarray(img2, jnp.float32),
                                             pts + np.array([4.0, 2.0], np.float32),
                                             jnp.asarray(pa), jnp.asarray(pb)))
    desc2 = np.concatenate([desc2, desc2[:10]])          # duplicates: the first index must win
    ok_cur = np.asarray(ok).copy()
    ok_cur[::7] = False
    ok_old = np.concatenate([np.asarray(ok), np.ones(10, bool)])
    ok_old[1::5] = False
    j_idx, j_m = jbrief.match_brief(jnp.asarray(desc), jnp.asarray(ok_cur), jnp.asarray(desc2),
                                    jnp.asarray(ok_old), 80)
    t_idx, t_m = tbrief.match_brief(_i32(desc), torch.as_tensor(ok_cur), _i32(desc2),
                                    torch.as_tensor(ok_old), 80)
    assert np.array_equal(np.asarray(j_idx), t_idx.numpy())
    assert np.array_equal(np.asarray(j_m), t_m.numpy())
    assert 30 < int(t_m.sum()) < len(ok_cur)


def test_bow_words_histogram_and_scores(pattern):
    pa, pb = pattern
    sel = jbow.word_selector()
    hists_j, hists_t = [], []
    for seed in range(5):
        img = jnp.asarray(_image(10 + seed), jnp.float32)
        pts, ok = jbrief.fast_detect(img, 20.0, 256)
        d = np.asarray(jbrief.brief_describe(img, pts, jnp.asarray(pa), jnp.asarray(pb)))
        ok = np.asarray(ok)
        wj = np.asarray(jbow.words_of(jnp.asarray(d), jnp.asarray(ok), jnp.asarray(sel)))
        wt = tbow.words_of(_i32(d), torch.as_tensor(ok), torch.as_tensor(sel))
        assert np.array_equal(wj, wt.numpy())
        hj, ht = jbow.bow_histogram(jnp.asarray(wj)), tbow.bow_histogram(wt)
        assert np.array_equal(np.asarray(hj), ht.numpy())
        hists_j.append(np.asarray(hj))
        hists_t.append(ht)
    idf = np.random.default_rng(1).uniform(1.0, 3.0, 4096).astype(np.float32)
    valid = np.array([True, True, False, True, True])
    sj = np.asarray(jbow.l1_scores(jnp.asarray(np.stack(hists_j)), jnp.asarray(valid),
                                   jnp.asarray(hists_j[0]), jnp.asarray(idf)))
    st = tbow.l1_scores(torch.stack(hists_t), torch.as_tensor(valid), hists_t[0],
                        torch.as_tensor(idf)).numpy()
    np.testing.assert_allclose(st, sj, atol=1e-6, rtol=0)
    assert st[2] == 0.0 and abs(st[0] - 1.0) < 1e-6


def _hist_for(k, n_words=4096):
    """Distinct sparse histogram for synthetic keyframe k (the case of
    tests/test_pose_graph_scale.py)."""
    h = np.zeros(n_words, np.float32)
    h[(10 * k) % n_words: (10 * k) % n_words + 10] = 0.1
    return h


@pytest.mark.parametrize("case", ["growth", "min_gap"])
def test_keyframe_database_replay_gives_the_same_answers(case):
    """Growth past capacity and the min_gap gate by keyframe index
    (tests/test_pose_graph_scale.py:34-60): every query answers the same."""
    if case == "growth":
        kw, adds = dict(capacity=8, min_gap=5), [(k, k) for k in range(30)]
        queries = [(q, 30) for q in (3, 27, 0, 12, 29)]
    else:
        kw, adds = dict(capacity=4, min_gap=50), [(k // 10, k) for k in range(0, 100, 10)]
        queries = [(q, 100) for q in (6, 4, 0, 9)]
    jdb, tdb = jbow.KeyframeDatabase(**kw), tbow.KeyframeDatabase(**kw, device="cpu")
    for h, k in adds:
        jdb.add(jnp.asarray(_hist_for(h)), kf_index=k)
        tdb.add(torch.as_tensor(_hist_for(h)), kf_index=k)
    assert tdb.capacity == jdb.capacity and tdb.count == jdb.count
    assert np.array_equal(tdb.kf_idx, jdb.kf_idx) and np.array_equal(tdb.doc_freq, jdb.doc_freq)
    answers = [tdb.query(torch.as_tensor(_hist_for(h)), cur) for h, cur in queries]
    assert answers == [jdb.query(jnp.asarray(_hist_for(h)), cur) for h, cur in queries]
    if case == "growth":
        assert answers[0] == 3 and answers[1] != 27
    else:
        assert answers[0] != 60 and answers[1] == 40


def test_dbow2_quantize_scores_and_database(tmp_path):
    rng = np.random.default_rng(0)
    k, L, ch, nd, wd, nw, n_words = _make_synthetic_vocab(rng, k=4, L=3)
    path = str(tmp_path / "voc.bin")
    tdbow.DBoW2Vocabulary.save_binary(path, k, L, ch, nd, wd, nw)
    with open(path, "rb") as fp:
        ours = fp.read()
    jdbow.DBoW2Vocabulary.save_binary(str(tmp_path / "j.bin"), k, L, ch, nd, wd, nw)
    with open(str(tmp_path / "j.bin"), "rb") as fp:
        assert fp.read() == ours                           # the same bytes on disk
    jv = jdbow.DBoW2Vocabulary.load_binary(path)
    tv = tdbow.DBoW2Vocabulary.load_binary(path, device="cpu")
    assert (tv.k, tv.L, tv.n_words) == (jv.k, jv.L, jv.n_words)

    leaves = np.nonzero(wd >= 0)[0]
    desc = np.concatenate([nd[leaves[:7]], rng.integers(0, 2**32, (40, 8), dtype=np.uint32)])
    ok = np.ones(len(desc), bool)
    ok[3] = False
    jw, jwt = jv.quantize(jnp.asarray(desc), jnp.asarray(ok))
    tw, twt = tv.quantize(_i32(desc), torch.as_tensor(ok))
    assert np.array_equal(np.asarray(jw), tw.numpy())
    assert np.array_equal(np.asarray(jwt), twt.numpy())

    jdb = jdbow.SparseBowDatabase(jv, capacity=4, max_words_per_kf=32, min_gap=2,
                                  score_best=0.2, score_min=0.1)
    tdb = tdbow.SparseBowDatabase(tv, capacity=4, max_words_per_kf=32, min_gap=2,
                                  score_best=0.2, score_min=0.1)
    sets = [rng.integers(0, 2**32, (30, 8), dtype=np.uint32) for _ in range(5)]
    ones = np.ones(30, bool)
    for i, s in enumerate(sets):
        vj, vt = jdb.bow_vector(s, ones), tdb.bow_vector(s, ones)
        assert np.array_equal(vj[0], vt[0]) and np.array_equal(vj[1], vt[1])
        assert tdb.query(vt, i) == jdb.query(vj, i)
        jdb.add(vj, kf_index=i)
        tdb.add(vt, kf_index=i)
    assert tdb.capacity == jdb.capacity == 8
    q = tdb.bow_vector(sets[1], ones)
    sj = np.asarray(jdbow.sparse_l1_scores(jdb.db_words, jdb.db_w, jdb.valid,
                                           jnp.asarray(q[0]), jnp.asarray(q[1])))
    st = tdbow.sparse_l1_scores(tdb.db_words, tdb.db_w, tdb.valid, torch.as_tensor(q[0]),
                                torch.as_tensor(q[1])).numpy()
    np.testing.assert_allclose(st, sj, atol=1e-6, rtol=0)
    assert abs(st[1] - 1.0) < 1e-6
    assert tdb.query(q, 6) == jdb.query(q, 6) >= 0


def _pnp_case():
    """The case of tests/test_global_layers.py::test_pnp_ransac_with_outliers:
    64 points, 20 of them with outlier observations, a drifted seed."""
    rng = np.random.default_rng(0)
    n = 64
    pts3d = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                      rng.uniform(3, 8, n)], axis=-1)
    R_gt = np.asarray(ypr_to_mat(jnp.asarray([0.2, -0.05, 0.1], jnp.float64)))
    t_gt = np.array([0.4, -0.2, 0.3])
    pts_w = pts3d @ R_gt.T + t_gt
    obs = pts3d[:, 0:2] / pts3d[:, 2:3]
    n_out = 20
    obs[:n_out] += rng.uniform(0.1, 0.3, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    pose_gt = np.concatenate([t_gt, np.asarray(mat_to_quat(jnp.asarray(R_gt)))])
    pose0 = pose_gt.copy()
    pose0[0:3] += rng.normal(0, 0.15, 3)
    valid = np.ones(n, bool)
    valid[-5:] = False
    return pose0, pts_w, obs, valid, pose_gt


def test_pnp_gn_matches_jax():
    pose0, pts_w, obs, valid, _ = _pnp_case()
    w = np.random.default_rng(3).uniform(0.0, 1.0, len(obs)) * valid
    gn = jax.jit(jpnp.pnp_gn, static_argnames="iters")
    want = np.asarray(gn(jnp.asarray(pose0), jnp.asarray(pts_w), jnp.asarray(obs),
                         jnp.asarray(w), iters=8))
    got = tpnp.pnp_gn(torch.as_tensor(pose0), torch.as_tensor(pts_w), torch.as_tensor(obs),
                      torch.as_tensor(w), 8).numpy()
    np.testing.assert_allclose(got, want, atol=1e-8, rtol=0)


def test_pnp_ransac_fed_the_jax_packages_noise():
    """The port takes its Gumbel draws as an argument; fed the JAX package's
    own draws for a key, it picks the same minimal sets: pose within 1e-8,
    the same inliers, the same verdict."""
    pose0, pts_w, obs, valid, pose_gt = _pnp_case()
    key = jax.random.PRNGKey(1)
    n = len(obs)
    noise = jax.vmap(lambda k: jax.random.gumbel(k, (n,), jnp.float64))(jax.random.split(key, 64))
    jp, ji, jok = jpnp.pnp_ransac(jnp.asarray(pose0), jnp.asarray(pts_w), jnp.asarray(obs),
                                  jnp.asarray(valid), key, min_inliers=25)
    tp, ti, tok = tpnp.pnp_ransac(torch.as_tensor(pose0), torch.as_tensor(pts_w),
                                  torch.as_tensor(obs), torch.as_tensor(valid),
                                  torch.as_tensor(np.asarray(noise)), min_inliers=25)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-8, rtol=0)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert bool(tok) == bool(jok) is True
    assert np.linalg.norm(tp.numpy()[0:3] - pose_gt[0:3]) < 0.02
    assert not bool(ti[-5:].any())


def test_gumbel_noise_is_seeded_and_standard():
    g = torch.Generator().manual_seed(0)
    a = tpnp.gumbel_noise(64, 500, g)
    b = tpnp.gumbel_noise(64, 500, torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and a.dtype == torch.float64 and a.shape == (64, 500)
    assert abs(float(a.mean()) - 0.5772) < 0.02 and abs(float(a.std()) - 1.2825) < 0.03
