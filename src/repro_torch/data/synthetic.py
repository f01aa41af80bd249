"""Synthetic datasets + micro-batching (port of ``repro/data/synthetic.py``).

numpy only, with the JAX package's generators and draw order, so the same
seeds give bit-identical batches. The offline stand-in for CIFAR-10/100 is
a learnable image task: each class has a random smooth template; samples
are template + noise. Text streams have Markov structure so next-token loss
is reducible.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np


@dataclass
class ImageTask:
    n_classes: int
    image_size: int
    templates: np.ndarray          # [C, H, W, 3]
    noise: float

    def sample(self, rng: np.random.Generator, n: int):
        labels = rng.integers(0, self.n_classes, n)
        x = self.templates[labels] + rng.normal(0, self.noise,
                                                (n, self.image_size,
                                                 self.image_size, 3))
        return x.astype(np.float32), labels.astype(np.int32)


def make_image_task(seed: int, n_classes: int = 10, image_size: int = 32,
                    noise: float = 0.35, smooth: int = 4) -> ImageTask:
    rng = np.random.default_rng(seed)
    raw = rng.normal(0, 1, (n_classes, image_size // smooth,
                            image_size // smooth, 3))
    tpl = np.repeat(np.repeat(raw, smooth, 1), smooth, 2)
    return ImageTask(n_classes, image_size, tpl.astype(np.float32), noise)


def image_batches(task: ImageTask, seed: int, batch: int, steps: int
                  ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        yield task.sample(rng, batch)


# ------------------------------------------------------------------- text
def markov_tokens(rng: np.random.Generator, pref: np.ndarray, vocab: int,
                  batch: int, seq: int,
                  order_bias: float = 6.0) -> np.ndarray:
    """Token batch from a FIXED sparse Markov chain ``pref`` (the chain must
    stay constant across batches or there is nothing to learn)."""
    toks = np.empty((batch, seq), np.int32)
    toks[:, 0] = rng.integers(0, vocab, batch)
    for t in range(1, seq):
        follow = rng.random(batch) < (order_bias / (order_bias + 1))
        toks[:, t] = np.where(follow, pref[toks[:, t - 1]],
                              rng.integers(0, vocab, batch))
    return toks


def lm_batches(seed: int, vocab: int, batch: int, seq: int, steps: int):
    rng = np.random.default_rng(seed)
    pref = rng.integers(0, vocab, vocab)        # the learnable structure
    for _ in range(steps):
        toks = markov_tokens(rng, pref, vocab, batch, seq + 1)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


# ------------------------------------------------------------- microbatching
def microbatch_assignment(batch: int, n_microbatches: int) -> np.ndarray:
    """[B] micro-batch id per sample (contiguous split, paper §III-A)."""
    if batch % n_microbatches:
        raise ValueError(f"batch {batch} does not split into "
                         f"{n_microbatches} micro-batches")
    return np.repeat(np.arange(n_microbatches), batch // n_microbatches)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def split_microbatches(arrays, n_microbatches: int):
    """Split the leading batch dim of every array in a nest of dicts,
    tuples and lists into a list of micro-batches."""
    def get(i):
        return _tree_map(
            lambda a: a[i * (a.shape[0] // n_microbatches):
                        (i + 1) * (a.shape[0] // n_microbatches)], arrays)
    return [get(i) for i in range(n_microbatches)]
