"""LFW-style 1:1 face-verification evaluation (the port's own copy of
hfa_gp_tpu/models/arcface/verification.py, plain numpy).

Embed both crops of each pair (plus horizontal flips), K-fold threshold
sweep on the squared L2 distance of normalised embeddings, report mean
accuracy and best threshold, the mean ROC, VAL@FAR and, optionally, the
per-fold PCA of the reference (arcface_torch/eval/verification.py).
`embed_fn` takes and returns numpy arrays; the flipped batch is handed to
it as a contiguous copy (torch tensors have no negative strides).
"""

from __future__ import annotations

import numpy as np


def _accuracy(threshold: float, dist: np.ndarray,
              issame: np.ndarray) -> float:
    pred = dist < threshold
    return float(np.mean(pred == issame))


def _tpr_fpr(threshold: float, dist: np.ndarray, issame: np.ndarray
             ) -> tuple[float, float]:
    """Parity: verification.py:109-121 (calculate_accuracy tp/fp rates)."""
    pred = dist < threshold
    tp = np.sum(pred & issame)
    fp = np.sum(pred & ~issame)
    tn = np.sum(~pred & ~issame)
    fn = np.sum(~pred & issame)
    tpr = 0.0 if tp + fn == 0 else tp / (tp + fn)
    fpr = 0.0 if fp + tn == 0 else fp / (fp + tn)
    return float(tpr), float(fpr)


def _pca_fit(x: np.ndarray, n_components: int):
    """Plain-numpy PCA (the reference uses sklearn.decomposition.PCA,
    verification.py:81-84): center + top-k right singular vectors."""
    mean = x.mean(axis=0)
    _, _, vt = np.linalg.svd(x - mean, full_matrices=False)
    return mean, vt[:n_components]


def _normalize(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


def evaluate_kfold(emb1: np.ndarray, emb2: np.ndarray, issame: np.ndarray,
                   n_folds: int = 10, pca: int = 0,
                   thresholds: np.ndarray | None = None,
                   far_target: float = 1e-3) -> dict:
    """Full reference `evaluate` surface (verification.py:41-190):
    K-fold accuracy, mean ROC curve over thresholds, per-fold PCA
    (pca>0: fit on the train split, transform all, re-normalize), and
    VAL@FAR (TPR at the threshold hitting `far_target` FAR on train).

    Inputs are raw (unnormalized) embeddings; normalization happens here
    (after PCA when enabled), matching the reference order."""
    if thresholds is None:
        thresholds = np.arange(0, 4, 0.01)
    issame = np.asarray(issame, bool)
    n = len(issame)
    folds = np.array_split(np.arange(n), n_folds)

    if pca == 0:
        e1, e2 = _normalize(emb1), _normalize(emb2)
        dist_all = np.sum((e1 - e2) ** 2, axis=1)

    tprs = np.zeros((n_folds, len(thresholds)))
    fprs = np.zeros((n_folds, len(thresholds)))
    accs, best_ts, vals, fars = [], [], [], []
    for k in range(n_folds):
        test_idx = folds[k]
        train_idx = np.concatenate([folds[j] for j in range(n_folds)
                                    if j != k])
        if pca > 0:
            mean, comps = _pca_fit(
                np.concatenate([emb1[train_idx], emb2[train_idx]]), pca)
            p1 = _normalize((emb1 - mean) @ comps.T)
            p2 = _normalize((emb2 - mean) @ comps.T)
            dist = np.sum((p1 - p2) ** 2, axis=1)
        else:
            dist = dist_all
        train_accs = [_accuracy(t, dist[train_idx], issame[train_idx])
                      for t in thresholds]
        best = thresholds[int(np.argmax(train_accs))]
        for ti, t in enumerate(thresholds):
            tprs[k, ti], fprs[k, ti] = _tpr_fpr(t, dist[test_idx],
                                                issame[test_idx])
        accs.append(_accuracy(best, dist[test_idx], issame[test_idx]))
        best_ts.append(best)

        # VAL@FAR (verification.py:124-176): threshold interpolated to
        # far_target on the train split, evaluated on test
        train_fars = np.array([_tpr_fpr(t, dist[train_idx],
                                        issame[train_idx])[1]
                               for t in thresholds])
        if train_fars.max() >= far_target:
            thr = float(np.interp(far_target, train_fars, thresholds))
        else:
            thr = 0.0
        val, far = _tpr_fpr(thr, dist[test_idx], issame[test_idx])
        vals.append(val)
        fars.append(far)

    return {
        "accuracy": float(np.mean(accs)), "accuracy_std": float(np.std(accs)),
        "threshold": float(np.mean(best_ts)),
        "tpr": tprs.mean(axis=0), "fpr": fprs.mean(axis=0),
        "thresholds": thresholds,
        "val": float(np.mean(vals)), "val_std": float(np.std(vals)),
        "far": float(np.mean(fars)), "far_target": far_target,
    }


def save_roc_plot(path: str, fpr: np.ndarray, tpr: np.ndarray,
                  label: str = "model") -> bool:
    """ROC plot on a log-FPR axis (utils/plot.py analog). Returns False
    (no file written) when matplotlib is unavailable in the image."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    order = np.argsort(fpr)
    fpr, tpr = np.asarray(fpr)[order], np.asarray(tpr)[order]
    auc = float(np.trapezoid(tpr, fpr)) if hasattr(np, "trapezoid") \
        else float(np.trapz(tpr, fpr))
    fig, ax = plt.subplots(figsize=(6, 5))
    ax.plot(np.maximum(fpr, 1e-7), tpr, lw=1.5,
            label=f"{label} (AUC = {auc * 100:.2f}%)")
    ax.set_xscale("log")
    ax.set_xlim(1e-6, 1.0)
    ax.set_xlabel("False Positive Rate")
    ax.set_ylabel("True Positive Rate")
    ax.grid(True, linestyle="--", linewidth=0.5)
    ax.legend(loc="lower right")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return True


def kfold_verification(emb1: np.ndarray, emb2: np.ndarray,
                       issame: np.ndarray, n_folds: int = 10,
                       thresholds: np.ndarray | None = None
                       ) -> tuple[float, float, float]:
    """(N,D),(N,D),(N,) → (mean_accuracy, std, best_threshold)."""
    r = evaluate_kfold(emb1, emb2, issame, n_folds=n_folds,
                       thresholds=thresholds)
    return r["accuracy"], r["accuracy_std"], r["threshold"]


def evaluate_pairs(embed_fn, images1: np.ndarray, images2: np.ndarray,
                   issame: np.ndarray, batch_size: int = 64,
                   use_flip: bool = True, pca: int = 0,
                   roc_out: str | None = None):
    """Run `embed_fn` (B,H,W,3)→(B,D) over pairs (with optional
    flip-augmented sum, verification.py convention) and K-fold verify.
    pca>0 enables the reference's per-fold PCA; roc_out writes the mean
    ROC curve plot."""
    def embed_all(imgs):
        outs = []
        for i in range(0, len(imgs), batch_size):
            chunk = imgs[i:i + batch_size]
            e = np.asarray(embed_fn(chunk))
            if use_flip:
                e = e + np.asarray(embed_fn(
                    np.ascontiguousarray(chunk[:, :, ::-1])))
            outs.append(e)
        return np.concatenate(outs)

    r = evaluate_kfold(embed_all(images1), embed_all(images2), issame,
                       pca=pca)
    if roc_out is not None:
        if save_roc_plot(roc_out, r["fpr"], r["tpr"]):
            print(f"ROC plot written to {roc_out}")
        else:
            print("matplotlib unavailable — skipping ROC plot")
    return r["accuracy"], r["accuracy_std"], r["threshold"]
