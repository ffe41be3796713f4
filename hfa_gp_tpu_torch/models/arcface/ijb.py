"""IJB-B/C template-based face verification and identification (the
port's own copy of hfa_gp_tpu/models/arcface/ijb.py, plain numpy on
embeddings).

The protocol of the reference's eval_ijbc.py: media-then-template
embedding pooling, 1:1 verification with a TAR@FAR readout, and rank-K
1:N identification.
"""

from __future__ import annotations

import numpy as np


def pool_templates(embeddings: np.ndarray, template_ids: np.ndarray,
                   media_ids: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Two-level pooling (IJB protocol): images → media (mean), media →
    template (sum, then unit-norm). Returns (templates (T, D),
    unique_template_ids)."""
    uniq_templates = np.unique(template_ids)
    out = np.zeros((len(uniq_templates), embeddings.shape[1]),
                   np.float32)
    for i, t in enumerate(uniq_templates):
        idx = template_ids == t
        embs = embeddings[idx]
        medias = media_ids[idx]
        pooled = []
        for m in np.unique(medias):
            pooled.append(embs[medias == m].mean(axis=0))
        agg = np.sum(pooled, axis=0)
        out[i] = agg / max(np.linalg.norm(agg), 1e-10)
    return out, uniq_templates


def verification_scores(templates: np.ndarray, template_ids: np.ndarray,
                        pairs: np.ndarray) -> np.ndarray:
    """Cosine similarity for (P, 2) template-id pairs."""
    id_to_row = {int(t): i for i, t in enumerate(template_ids)}
    a = templates[[id_to_row[int(p)] for p in pairs[:, 0]]]
    b = templates[[id_to_row[int(p)] for p in pairs[:, 1]]]
    return np.sum(a * b, axis=1)


def tar_at_far(scores: np.ndarray, labels: np.ndarray,
               far_targets=(1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1)
               ) -> dict[float, float]:
    """ROC readout: true-accept rate at fixed false-accept rates
    (the reference reports IJB-C@1e-4 / 1e-5)."""
    pos = np.sort(scores[labels == 1])
    neg = np.sort(scores[labels == 0])[::-1]
    out = {}
    for far in far_targets:
        k = int(far * len(neg))
        thr = neg[min(k, len(neg) - 1)]
        out[far] = float(np.mean(pos > thr))
    return out


def rank_k_identification(probe: np.ndarray, gallery: np.ndarray,
                          probe_labels: np.ndarray,
                          gallery_labels: np.ndarray,
                          ks=(1, 5, 10)) -> dict[int, float]:
    """1:N closed-set identification accuracy at rank K."""
    sims = probe @ gallery.T
    order = np.argsort(-sims, axis=1)
    ranked = gallery_labels[order]
    out = {}
    for k in ks:
        hit = (ranked[:, :k] == probe_labels[:, None]).any(axis=1)
        out[k] = float(np.mean(hit))
    return out
