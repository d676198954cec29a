"""The edit loop's inputs, drawn from the seed: the masked column range of
each edit (dealt in decks), its pitch and family, the first codes. Nothing
here imports torch: the driver draws its inputs while the server
process starts."""

from __future__ import annotations

from typing import List

import numpy as np

from harness.seeds import derive


def column_ranges(columns: int):
    return [(a, b) for a in range(columns) for b in range(a + 1, columns + 1)]


class Plan:
    """The inputs of every edit, from the seed."""

    def __init__(self, cfg: dict, seed: int):
        self.cfg = cfg
        self.ranges = column_ranges(cfg["top_prior"]["shape"][1])
        self.deck_rng = np.random.default_rng(derive(seed, "decks"))
        self.label_rng = np.random.default_rng(derive(seed, "labels"))
        self.decks: List = []
        code_rng = np.random.default_rng(derive(seed, "codes"))
        self.top = code_rng.integers(0, cfg["top_prior"]["n_class"],
                                     cfg["top_prior"]["shape"])
        self.bottom = code_rng.integers(0, cfg["bottom_prior"]["n_class"],
                                        cfg["bottom_prior"]["shape"])
        self.labels: List = []

    def cols(self, k: int):
        while len(self.decks) * len(self.ranges) <= k:
            order = self.deck_rng.permutation(len(self.ranges))
            self.decks.append([self.ranges[i] for i in order])
        return self.decks[k // len(self.ranges)][k % len(self.ranges)]

    def label(self, k: int):
        while len(self.labels) <= k:
            self.labels.append({
                name: classes[int(self.label_rng.integers(len(classes)))]
                for name, classes in self.cfg["labels"].items()})
        return self.labels[k]


def column_masks(cfg: dict, cols):
    """(top mask [F, T], bottom mask [F', T']) of a mask over the top
    codemap's columns [a, b), the bottom one repeated over each top cell's
    patch."""
    f_t, t_t = cfg["top_prior"]["shape"]
    f_b, t_b = cfg["bottom_prior"]["shape"]
    top = np.zeros((f_t, t_t), bool)
    top[:, cols[0]:cols[1]] = True
    bottom = np.repeat(np.repeat(top, f_b // f_t, 0), t_b // t_t, 1)
    return top, bottom
