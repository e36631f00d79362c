"""Draft-free speculative decoding: prompt-lookup n-gram drafting
(a copy of analytics_zoo_tpu/serving/generation/speculation.py, which
is host-only).

A drafter guesses the next k tokens of a lane from its own history, ONE
verify step scores them against the model, and the longest prefix that
matches the model's own greedy choice is accepted, plus the token the
verify logits give for the position after it: up to k+1 tokens a round
instead of 1.

Drafting (`ngram_draft`): suffix-match the last `max_ngram..min_ngram`
tokens of the lane's prompt+generated history against every earlier
position; the tokens FOLLOWING the most recent earlier match are the
proposal.  No match, or a lane whose recent proposals were all rejected
(the exponential cooldown of `SpecState`), means no draft: the lane
takes the normal decode step.

Verification is the engine's verify step (one per pow2 k-bucket): the
pending token plus the drafted tokens run through the paged ctx read
(`ops.attention.paged_verify_attention`), greedy argmax at every
position.  Accepted tokens are by construction those single-step greedy
decode would emit.  Rejection is a free-list operation: the lane's
over-allocated blocks go back through the refcounted `BlockAllocator`
(`SlotScheduler.rollback_speculation`).
"""

from __future__ import annotations

from typing import List, Optional

#: default n-gram window the drafter matches on (longest first)
DEFAULT_MAX_NGRAM = 3
#: shortest suffix worth matching.  2, not 1: on incompressible
#: traffic a single repeated token is common enough that 1-gram drafts
#: fire (and get rejected) every few rounds even through the cooldown,
#: while a repeated PAIR is rare in random text and ubiquitous in the
#: templated traffic speculation targets — bench.py's adversarial
#: <= 1.1x slowdown gate is measured against this default
DEFAULT_MIN_NGRAM = 2
#: cooldown (in scheduling rounds) after the FIRST fully-rejected
#: proposal; doubles per consecutive rejection up to COOLDOWN_MAX
COOLDOWN_START = 2
COOLDOWN_MAX = 32


def ngram_draft(ctx: List[int], k: int, *,
                max_ngram: int = DEFAULT_MAX_NGRAM,
                min_ngram: int = DEFAULT_MIN_NGRAM,
                eos_id: Optional[int] = None) -> List[int]:
    """Prompt-lookup proposal: up to `k` tokens that followed the most
    recent earlier occurrence of the history's suffix n-gram (longest
    n first).  Returns [] when nothing matches (the k=0 round: the
    lane simply decodes normally).  A proposal is clipped just past
    `eos_id` — drafting beyond the end of the sequence is dead weight
    in the verify step."""
    n_ctx = len(ctx)
    if k <= 0 or n_ctx < min_ngram + 1:
        return []
    for n in range(min(max_ngram, n_ctx - 1), min_ngram - 1, -1):
        pattern = ctx[-n:]
        # rightmost occurrence strictly before the suffix itself, so
        # at least one continuation token exists
        for i in range(n_ctx - n - 1, -1, -1):
            if ctx[i:i + n] == pattern:
                prop = ctx[i + n:i + n + k]
                if eos_id is not None and eos_id in prop:
                    prop = prop[:prop.index(eos_id) + 1]
                return list(prop)
    return []


class SpecState:
    """Per-lane draft state (hangs off `Sequence.spec`, scheduler.py).

    Counters feed the request-log `spec_propose`/`spec_accept` events
    (pow2-sampled on `rounds`) and survive preemption — drafting reads
    only the token history, which recompute-on-resume preserves."""

    __slots__ = ("rounds", "proposed", "accepted", "cooldown",
                 "penalty")

    def __init__(self):
        self.rounds = 0      # verify rounds this lane ran
        self.proposed = 0    # drafted tokens fed to verify
        self.accepted = 0    # drafted tokens accepted
        self.cooldown = 0    # rounds left to sit out after rejections
        self.penalty = 0     # current backoff width (0 = none)

    def record(self, proposed: int, accepted: int) -> None:
        """Fold one verify round's outcome into the backoff policy:
        any acceptance resets the penalty; a full rejection doubles it
        (COOLDOWN_START first, capped at COOLDOWN_MAX) — incompressible
        traffic converges to one probe per COOLDOWN_MAX rounds."""
        self.rounds += 1
        self.proposed += proposed
        self.accepted += accepted
        if accepted > 0:
            self.penalty = 0
            self.cooldown = 0
        else:
            self.penalty = (COOLDOWN_START if self.penalty == 0
                            else min(self.penalty * 2, COOLDOWN_MAX))
            self.cooldown = self.penalty


class Speculator:
    """Drafting policy + k-bucket geometry for one engine.

    `k` is the max drafted tokens per lane per round
    (`OrcaContext.speculative_k`).  The verify step's width is a pow2
    bucket (`buckets`), so draft lengths map onto O(log k) shapes, each
    run once by the engine's `warmup()`."""

    def __init__(self, k: int,
                 max_ngram: int = DEFAULT_MAX_NGRAM,
                 min_ngram: int = DEFAULT_MIN_NGRAM):
        if k < 1:
            raise ValueError(f"speculative_k must be >= 1, got {k}")
        self.k = int(k)
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)
        buckets = []
        b = 2
        while b < self.k:
            buckets.append(b)
            b *= 2
        buckets.append(self.k)
        #: pow2 draft-length buckets, largest == k (k=8 -> (2, 4, 8))
        self.buckets = tuple(buckets)

    def bucket_for(self, n: int) -> int:
        """Smallest verify bucket covering an n-token draft."""
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"draft length {n} exceeds speculative_k "
                         f"{self.k}")

    def expected_verify_variants(self) -> int:
        """The verify shapes the k-bucket geometry implies: one per
        pow2 bucket."""
        return len(self.buckets)

    def state(self, seq) -> SpecState:
        """The lane's draft state, created on first use."""
        if seq.spec is None:
            seq.spec = SpecState()
        return seq.spec

    def draft_for(self, seq) -> List[int]:
        """Propose a draft for one running lane: n-gram lookup over
        prompt+generated, capped so accepted tokens + the bonus token
        never exceed the request's remaining `max_new_tokens` (the
        last token of a request always comes from a normal accept or
        decode round)."""
        remaining = seq.max_new_tokens - len(seq.generated)
        k_eff = min(self.k, remaining - 1)
        if k_eff < 1:
            return []
        return ngram_draft(seq.prompt + seq.generated, k_eff,
                           max_ngram=self.max_ngram,
                           min_ngram=self.min_ngram,
                           eos_id=seq.eos_id)
