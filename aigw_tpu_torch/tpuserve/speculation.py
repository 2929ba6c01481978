"""Adaptive multi-source speculative decoding (counterpart of
``aigw_tpu/tpuserve/speculation.py``).

No draft model: the engine guesses the next D tokens, verifies all D+1
positions in one model step (``models/llama.py verify_step``) and
accepts the longest draft prefix that matches the model's own
per-position samples. Two draft sources, both tensor functions on the
device:

- **n-gram prompt lookup** (``ngram_drafts``): the continuation of the
  most recent earlier occurrence of the current 2-gram in the slot's
  own token history ``[B, H]``;
- **prefix-cache continuation** (``lookahead_drafts``): one page of
  tokens that followed the cached prompt prefix last time. Prefix
  caching is not ported yet, so the engine's lookahead buffer stays
  empty and n-gram drafts serve every slot (``combine_drafts`` falls
  back to them), exactly the reference with its prefix cache off.

Per-position sampling keys are derived from the absolute position, so
accepted tokens are drawn from exactly the distribution plain decoding
would use: speculation on and off give identical streams. A rejected
draft's K/V rows sit past the accepted position, where the causal mask
cannot reach them until a later step rewrites them.

**Adaptive draft length.** Each eligible slot (greedy, no repetition
penalties) carries a ``DraftController`` walking a rung ladder
(``draft_rungs``) on a rolling acceptance EWMA, collapsing to rung 0
(the plain decode window) when drafts are rejected and re-probing now
and then; new slots start from the engine-wide ``AcceptancePrior``.
Sampled and penalized slots decode plainly: their drafts are poisoned
to -1 on the device and they never lift the dispatched rung.
"""

from __future__ import annotations

import torch

# -- adaptive-ladder tuning (the reference's constants) --------------------
#: EWMA weight of each window's per-draft acceptance ratio
EWMA_ALPHA = 0.5
#: drop one rung when the acceptance EWMA falls below this
RUNG_DOWN_BELOW = 0.35
#: climb one rung when the acceptance EWMA rises above this
RUNG_UP_ABOVE = 0.75
#: EWMA decay per window in which the sources proposed nothing
NO_PROPOSAL_DECAY = 0.85
#: windows a collapsed (rung-0) slot waits before re-probing rung 1
REPROBE_WINDOWS = 64
#: weight of each window in the engine-wide acceptance prior
PRIOR_ALPHA = 0.05
#: prior at/above which a fresh slot starts at the top rung
PRIOR_OPTIMISTIC = 0.6
#: prior below which a fresh slot starts collapsed (rung 0)
PRIOR_PESSIMISTIC = 0.35


def draft_rungs(max_tokens: int) -> tuple[int, ...]:
    """The draft-length ladder for a ``spec_tokens`` budget: rung 0 plus
    power-of-two rungs up to the budget (8 → (0, 2, 4, 8); 3 → (0, 2,
    3))."""
    if max_tokens <= 0:
        return (0,)
    rungs = {0, max_tokens}
    d = 2
    while d < max_tokens:
        rungs.add(d)
        d *= 2
    return tuple(sorted(rungs))


class AcceptancePrior:
    """Engine-wide rolling estimate of draft acceptance; fresh slots
    start their controller from it."""

    def __init__(self) -> None:
        self.value = 1.0

    def observe(self, ratio: float) -> None:
        self.value += PRIOR_ALPHA * (ratio - self.value)

    def initial_rung(self, n_rungs: int) -> int:
        if n_rungs <= 1:
            return 0
        if self.value >= PRIOR_OPTIMISTIC:
            return n_rungs - 1
        if self.value < PRIOR_PESSIMISTIC:
            return 0
        return max(1, (n_rungs - 1) // 2)


class DraftController:
    """Per-slot adaptive draft length over a rung ladder. ``tick()`` runs
    at every dispatch (at rung 0 it counts idle windows and re-probes);
    ``observe_window()`` runs at drain with the window's proposed and
    accepted draft counts and returns the rung move it made (-1/0/+1)."""

    def __init__(self, rungs: tuple[int, ...], prior: AcceptancePrior,
                 adaptive: bool = True) -> None:
        self.rungs = rungs
        self.prior = prior
        self.adaptive = adaptive
        self.rung = (len(rungs) - 1 if not adaptive
                     else prior.initial_rung(len(rungs)))
        # a fresh slot inherits the prior's optimism but never starts
        # below the demotion line
        self.ewma = max(prior.value, RUNG_DOWN_BELOW) if adaptive else 1.0
        self.idle_windows = 0

    def draft_len(self) -> int:
        return self.rungs[self.rung]

    def tick(self) -> int:
        if self.adaptive and self.rung == 0 and len(self.rungs) > 1:
            self.idle_windows += 1
            if self.idle_windows >= REPROBE_WINDOWS:
                # one window at the smallest rung, the EWMA on the
                # demotion line: one bad window sends it back to 0
                self.idle_windows = 0
                self.rung = 1
                self.ewma = RUNG_DOWN_BELOW
        return self.draft_len()

    def observe_window(self, proposed: int, accepted: int) -> int:
        """``proposed`` = draft tokens the sources actually offered this
        window (not the configured width)."""
        if not self.adaptive:
            return 0
        if proposed > 0:
            ratio = accepted / proposed
            self.prior.observe(ratio)
            self.ewma += EWMA_ALPHA * (ratio - self.ewma)
        else:
            self.prior.observe(0.0)
            self.ewma *= NO_PROPOSAL_DECAY
        if self.ewma < RUNG_DOWN_BELOW and self.rung > 0:
            self.rung -= 1
            self.idle_windows = 0
            return -1
        if self.ewma > RUNG_UP_ABOVE and self.rung < len(self.rungs) - 1:
            self.rung += 1
            return 1
        return 0


# -- draft sources (tensor functions on the device) -------------------------
def ngram_drafts(history: torch.Tensor,  # [B, H] int32 prompt + generated
                 positions: torch.Tensor,  # [B] history valid through here
                 n_draft: int) -> torch.Tensor:
    """``n_draft`` proposals per slot from an earlier occurrence of the
    last 2-gram: the most recent match whose continuation has all
    ``n_draft`` tokens in history, else the most recent match (its
    continuation clips at ``positions``). Returns ``[B, n_draft]`` in
    history's dtype; -1 marks "no proposal"."""
    B, H = history.shape
    dev = history.device
    pos = positions.long()[:, None]  # [B, 1]
    last1 = torch.gather(history, 1, torch.clamp(pos, 0, H - 1))
    last0 = torch.gather(history, 1, torch.clamp(pos - 1, 0, H - 1))
    t = torch.arange(H - 1, device=dev)[None, :]  # match start index
    m = (history[:, :-1] == last0) & (history[:, 1:] == last1)
    # the match ends strictly before the current 2-gram starts
    m = m & (t < pos - 1)
    found = m.any(dim=1)
    neg = torch.full_like(t, -1)
    j_any = torch.argmax(torch.where(m, t, neg), dim=1)  # most recent
    m_full = m & (t + 1 + n_draft <= pos)  # full continuation on hand
    j_full = torch.argmax(torch.where(m_full, t, neg), dim=1)
    j = torch.where(m_full.any(dim=1), j_full, j_any)
    d = torch.arange(n_draft, device=dev)[None, :]
    src = j[:, None] + 2 + d  # [B, n_draft]
    valid = found[:, None] & (src <= pos)
    drafts = torch.gather(history, 1, torch.clamp(src, 0, H - 1))
    return torch.where(valid, drafts, torch.full_like(drafts, -1))


def lookahead_drafts(lookahead: torch.Tensor,  # [B, L] continuation tokens
                     la_base: torch.Tensor,  # [B] position of lookahead[:, 0]
                     la_len: torch.Tensor,  # [B] valid length (0 = none)
                     positions: torch.Tensor,  # [B] pending-token position
                     n_draft: int) -> torch.Tensor:
    """Position ``pos + 1 + d`` proposes ``lookahead[pos + 1 + d -
    la_base]`` where that offset is in range; -1 elsewhere. Returns
    ``[B, n_draft]`` in lookahead's dtype."""
    L = lookahead.shape[1]
    d = torch.arange(n_draft, device=lookahead.device)[None, :]
    off = positions.long()[:, None] + 1 + d - la_base.long()[:, None]
    valid = (off >= 0) & (off < la_len.long()[:, None])
    toks = torch.gather(lookahead, 1, torch.clamp(off, 0, L - 1))
    return torch.where(valid, toks, torch.full_like(toks, -1))


def combine_drafts(primary: torch.Tensor,
                   fallback: torch.Tensor) -> torch.Tensor:
    """The primary proposal where it exists (>= 0), else the fallback's.
    Both ``[B, D]``."""
    return torch.where(primary >= 0, primary, fallback)


def accept_counts(drafts: torch.Tensor,  # [B, D]
                  sampled: torch.Tensor,  # [B, D + 1]
                  ) -> torch.Tensor:
    """Longest matching prefix: the number of accepted drafts ``[B]``
    (int32, in [0, D]); ``sampled[:, d]`` is the model's token for the
    position after draft d - 1."""
    match = (drafts == sampled[:, :drafts.shape[1]]).to(torch.int32)
    return torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)
