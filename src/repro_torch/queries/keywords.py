"""Vocabulary-hashed term dimension for spatio-textual pub/sub.

A ``spatial_keyword`` subscription is a spatial rectangle AND a keyword
conjunction: a tuple is delivered iff it falls inside the rectangle and
its term set contains every subscription term.  Terms are folded into
``T`` hash buckets so the per-partition textual state is a fixed-width
histogram instead of a vocabulary-sized index:

* a tuple carrying terms ``{a, b}`` probes buckets ``{h(a), h(b)}``
  plus the *wildcard* bucket ``T`` (subscriptions with no keywords);
* a subscription is indexed under a single **pivot** bucket — the
  minimum of its term buckets (or the wildcard bucket when it has no
  keywords) — so every subscription appears in exactly one posting
  list and the per-partition inverted index ``qres_kw`` stays a dense
  ``(P, T + 1)`` histogram.

Collision semantics: hashing is conservative.  A tuple's candidate set
(union of the posting lists of its buckets) is a **superset** of its
exact matches — a collision can only *overcount* (two different terms
landing in one bucket), never drop a true match.  Exact conjunction
filtering happens in ``repro.kernels.keyword_match`` over the candidate
masks; the histogram path is used for expectation-space cost accounting
(SWARM's ``C(p)`` terms) where the overcount bound is documented in
DESIGN.md §10.
"""
from __future__ import annotations

import dataclasses
import re
import zlib

import numpy as np

__all__ = [
    "TermHasher",
    "SubscriptionIndex",
    "bucket_masks",
    "bucket_onehot",
    "tokenize",
]

_TOKEN_RE = re.compile(r"[a-z0-9#@_]+")


def tokenize(text: str) -> list[str]:
    """Lower-cased alphanumeric/hashtag tokens of a text document."""
    return _TOKEN_RE.findall(text.lower())


def _mix32(x: np.ndarray) -> np.ndarray:
    """Deterministic 32-bit integer mixer (xorshift-multiply).

    Not Python ``hash`` (randomized per process) — replays and the
    NumPy/JAX planes must agree on bucket placement bit-for-bit.
    """
    x = np.asarray(x, np.int64) & 0xFFFFFFFF
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & 0xFFFFFFFF
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & 0xFFFFFFFF
    return x ^ (x >> 16)


def bucket_onehot(bucket_ids: np.ndarray, n_buckets: int) -> np.ndarray:
    """(N, K) bucket ids (−1 = pad) → (N, T + 1) float32 indicators.

    Column ``T`` is the wildcard bucket; assignment (not accumulation)
    makes the rows set-valued, so duplicate ids count once.
    """
    ids = np.asarray(bucket_ids, np.int64)
    ids = ids.reshape(ids.shape[0], -1) if ids.ndim > 1 else ids[:, None]
    n, k = ids.shape
    out = np.zeros((n, n_buckets + 1), np.float32)
    if k:
        rows = np.repeat(np.arange(n), k)
        cols = ids.reshape(-1)
        ok = (cols >= 0) & (cols <= n_buckets)
        out[rows[ok], cols[ok]] = 1.0
    return out


def bucket_masks(bucket_ids: np.ndarray, n_buckets: int) -> np.ndarray:
    """Like :func:`bucket_onehot` without the wildcard column — the
    (N, T) indicator layout the exact-matching kernel consumes."""
    return bucket_onehot(bucket_ids, n_buckets)[:, :n_buckets]


@dataclasses.dataclass(frozen=True)
class TermHasher:
    """Folds integer term ids (or string tokens) into ``T`` buckets."""

    n_buckets: int = 32

    @property
    def wildcard(self) -> int:
        """Bucket id reserved for keyword-free subscriptions."""
        return self.n_buckets

    def buckets(self, terms) -> np.ndarray:
        """Element-wise term → bucket; −1 padding passes through."""
        terms = np.asarray(terms, np.int64)
        out = (_mix32(terms) % self.n_buckets).astype(np.int32)
        return np.where(terms < 0, np.int32(-1), out)

    def token_buckets(self, tokens) -> np.ndarray:
        """String tokens → buckets (crc32 then the same mixer)."""
        ids = [zlib.crc32(t.encode("utf-8")) for t in tokens]
        return self.buckets(np.asarray(ids, np.int64))

    def tuple_buckets(self, terms) -> np.ndarray:
        """(N, K) tuple terms → (N, K + 1) deduplicated probe buckets.

        The trailing column is always the wildcard bucket; repeated
        buckets within a tuple collapse to −1 so histogram probes and
        one-hot probes agree exactly.
        """
        terms = np.asarray(terms, np.int64)
        terms = terms.reshape(terms.shape[0], -1)
        n, k = terms.shape
        ids = np.full((n, k + 1), -1, np.int32)
        ids[:, -1] = self.wildcard
        if k:
            b = np.sort(self.buckets(terms), axis=1)
            dup = np.zeros(b.shape, bool)
            dup[:, 1:] = b[:, 1:] == b[:, :-1]
            ids[:, :k] = np.where(dup, np.int32(-1), b)
        return ids

    def sub_masks(self, terms) -> np.ndarray:
        """(Q, K) subscription terms → (Q, T) float32 bucket masks
        (conjunction: a tuple matches iff its mask covers the row)."""
        terms = np.asarray(terms, np.int64)
        terms = terms.reshape(terms.shape[0], -1)
        return bucket_masks(self.buckets(terms), self.n_buckets)

    def pivots(self, terms, n: int | None = None) -> np.ndarray:
        """(Q, K) subscription terms → (Q,) pivot buckets.

        Pivot = min term bucket, or the wildcard bucket for rows with
        no keywords.  ``terms=None`` yields ``n`` wildcard pivots.
        """
        if terms is None:
            return np.full(0 if n is None else n, self.wildcard, np.int32)
        terms = np.asarray(terms, np.int64)
        terms = terms.reshape(terms.shape[0], -1)
        if terms.shape[1] == 0:
            return np.full(terms.shape[0], self.wildcard, np.int32)
        b = self.buckets(terms)
        b = np.where(b < 0, np.int32(self.wildcard), b)
        return b.min(axis=1).astype(np.int32)


@dataclasses.dataclass
class SubscriptionIndex:
    """Standing subscriptions + pivot-bucket inverted index.

    Candidates for a tuple are the union of the posting lists of its
    probe buckets (pivot CSR) — never a linear scan over all standing
    subscriptions.  Exactness: a subscription's pivot is one of its
    term buckets, and a matching tuple carries *all* of them, so the
    candidate union is a superset of the exact matches.
    """

    rects: np.ndarray                 # (Q, 4) float32 spatial predicates
    masks: np.ndarray                 # (Q, T) float32 bucket indicators
    pivots: np.ndarray                # (Q,) int32 in [0, T]
    _order: np.ndarray = dataclasses.field(init=False, repr=False)
    _starts: np.ndarray = dataclasses.field(init=False, repr=False)

    def __post_init__(self) -> None:
        t1 = self.masks.shape[1] + 1
        self._order = np.argsort(self.pivots, kind="stable").astype(np.int64)
        self._starts = np.searchsorted(self.pivots[self._order],
                                       np.arange(t1 + 1)).astype(np.int64)

    @classmethod
    def build(cls, hasher: TermHasher, rects, terms=None):
        rects = np.asarray(rects, np.float32)
        return cls(rects=rects, masks=hasher.sub_masks(
            terms if terms is not None else np.zeros((len(rects), 0))),
            pivots=hasher.pivots(terms, n=len(rects)))

    def __len__(self) -> int:
        return len(self.rects)

    def posting(self, bucket: int) -> np.ndarray:
        """Subscription ids whose pivot is ``bucket``."""
        return self._order[self._starts[bucket]:self._starts[bucket + 1]]

    def candidates(self, bucket_ids) -> np.ndarray:
        """Union of posting lists for a batch's probe buckets (sorted
        unique subscription ids)."""
        ids = np.unique(np.asarray(bucket_ids, np.int64).reshape(-1))
        ids = ids[ids >= 0]
        if len(ids) == 0:
            return np.zeros(0, np.int64)
        return np.unique(np.concatenate(
            [self.posting(int(b)) for b in ids]))
