"""The f* rule and the judgement of the program's answers, in float32 and
numpy.

Each partitioning is (name, tokens, lat, lng), coarse to fine, as the
benchmark made it. The ancestor of a fine cell in a coarser partitioning is
its deepest S2 ancestor (or itself) among that partitioning's cells, found
here from the tokens by the S2 id algebra: the parent of an id at level L
keeps the bits above the level's sentinel bit 1 << 2 (30 - L)."""

from __future__ import annotations

import math

import numpy as np
import torch


def token_ids(tokens):
    """Hex tokens -> uint64 S2 ids (the token is the id's hex digits with
    the trailing zeros stripped)."""
    return np.array([int(str(t).ljust(16, "0"), 16) for t in tokens],
                    dtype=np.uint64)


def _level(ids):
    lsb = ids & (~ids + np.uint64(1))
    return np.array([30 - (int(v).bit_length() - 1) // 2 for v in lsb])


def ancestor_maps(parts):
    """[(n_fine,) int64] per partitioning (the last the identity) and the
    (n_fine,) mask of fine cells that have an ancestor in each."""
    fine = token_ids(parts[-1][1])
    fine_level = _level(fine)
    maps, valid = [], np.ones(len(fine), bool)
    for _, tokens, _, _ in parts[:-1]:
        ids = token_ids(tokens)
        order = np.argsort(ids)
        sorted_ids = ids[order]
        found = np.full(len(fine), -1, np.int64)
        for level in range(30, -1, -1):
            lsb = np.uint64(1) << np.uint64(2 * (30 - level))
            anc = (fine & ~(lsb - np.uint64(1)) & ~lsb) | lsb
            pos = np.clip(np.searchsorted(sorted_ids, anc), 0, len(ids) - 1)
            hit = ((sorted_ids[pos] == anc) & (found < 0)
                   & (fine_level >= level))
            found[hit] = order[pos[hit]]
        valid &= found >= 0
        maps.append(np.where(found < 0, 0, found))
    maps.append(np.arange(len(fine)))
    return maps, valid


def fold_prob_mean(crop_logits, n_crops=10):
    """(B * n, C) -> (B, C): the log of the crops' mean softmax."""
    lp = torch.log_softmax(crop_logits.float().reshape(
        -1, n_crops, crop_logits.shape[-1]), dim=-1)
    return torch.logsumexp(lp, dim=1) - math.log(n_crops)


def scores(crop_logits, parts, maps, valid, n_crops=10):
    """{p_key: (B, C) float32 scores} whose argmax is the answer: each
    head's folded log-probabilities, and for 'hierarchy' the f* score of
    every fine cell, the sum of its ancestors' log-probabilities (cells
    without every ancestor at -inf)."""
    sizes = [len(p[1]) for p in parts]
    heads = torch.split(crop_logits, sizes, dim=-1)
    out, total = {}, 0.0
    for (name, *_), head, m in zip(parts, heads, maps):
        lp = fold_prob_mean(head, n_crops)
        out[name] = lp
        total = total + torch.log_softmax(lp, dim=-1)[
            :, torch.as_tensor(m, device=lp.device)]
    mask = torch.as_tensor(valid, device=total.device)
    out["hierarchy"] = torch.where(mask, total, torch.tensor(
        -math.inf, device=total.device))
    return out


def centers(parts):
    """{p_key: (lat, lng)} float32 cell centers by class, 'hierarchy' the
    finest partitioning's."""
    out = {name: (np.float32(lat), np.float32(lng))
           for name, _, lat, lng in parts}
    out["hierarchy"] = out[parts[-1][0]]
    return out


def judge(answers, ref_scores, parts):
    """Holds the program's answers {p_key: (cls, lat, lng)} of B images
    against the reference's scores of the same images. The gap of an
    answer is by how much the reference's score of the program's class
    lies below the reference's best. Returns sums over every image and
    p_key: {"answers", "gap_sum", "max_gap", "disagree" (answers off the
    reference's best class), "coords_off" (coordinates other than the
    class's own cell center, rounded to float32), "classes_out_of_range"}."""
    coords = centers(parts)
    out = {"answers": 0, "gap_sum": 0.0, "max_gap": 0.0, "disagree": 0,
           "coords_off": 0, "classes_out_of_range": 0}
    for key, s in ref_scores.items():
        cls, lat, lng = (np.asarray(a) for a in answers[key])
        cls = cls.astype(np.int64)
        inside = (cls >= 0) & (cls < s.shape[1])
        c = np.where(inside, cls, 0)
        s = s.double().cpu()
        chosen = s[torch.arange(len(c)), torch.as_tensor(c)]
        g = (s.max(dim=1).values - chosen).numpy()
        g = np.where(inside & np.isfinite(g), g, np.inf)
        clat, clng = coords[key]
        out["answers"] += len(c)
        out["gap_sum"] += float(g.sum())
        out["max_gap"] = max(out["max_gap"], float(g.max()))
        out["disagree"] += int((g > 0).sum())
        out["coords_off"] += int(((clat[c] != np.float32(lat))
                                  | (clng[c] != np.float32(lng))
                                  | ~inside).sum())
        out["classes_out_of_range"] += int((~inside).sum())
    return out
