"""Node health monitoring from measured-vs-predicted telemetry.

A copy of ``repro.health.monitor`` for the port.

The monitor sees every telemetry observation the simulator already
feeds the calibration loop: (job, model key, placement nodes, measured
T_iter, predicted T_iter).  A *suspect* observation is one whose
measured/predicted ratio exceeds ``suspect_ratio`` — but a suspect
observation alone is ambiguous: the model fit may have drifted, or one
of several placement nodes may be throttled.  Disambiguation uses
cross-job evidence:

  * **node attribution** — intersect the placements of suspect
    observations; a node present in many suspect placements while
    disjoint placements stay healthy is the culprit (single-node
    placements are self-attributing);
  * **not-drift** — drift slows every placement of a model key equally,
    so suspects spanning several model keys, or a healthy observation
    of the same key on a disjoint placement, rule drift out.

Health is an append-only ledger of (t, node, delta, reason) entries;
the live score of a node is ``clip(1.0 + sum(deltas))`` applied
sequentially, which the sanitizer recomputes for exact agreement.
Scores are debited on blame (``blame_debit``) and on flaky-operation
failures (via :meth:`debit`), credited per healthy observation, and a
node whose score falls below ``quarantine_below`` is quarantined.
Quarantined nodes receive no observations (their jobs migrate away),
so release is probation-based: after ``probation_s`` the node re-enters
at ``recover_above`` and must earn the rest back.

The monitor also exports ``excluded_nodes`` — the set the calibration
manager must mask so degraded observations never trigger bogus refits.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class HealthConfig:
    suspect_ratio: float = 1.35   # measured/predicted ⇒ suspect
    window_s: float = 1800.0      # evidence window per node
    min_suspect: int = 4          # suspect obs needed to blame a node
    suspect_frac: float = 0.7     # suspect share of the node's window
    blame_debit: float = 0.6      # score hit when blamed
    op_debit: float = 0.35        # score hit per exhausted flaky op
    heal_credit: float = 0.1      # score credit per healthy obs
    quarantine_below: float = 0.5
    recover_above: float = 0.8    # hysteresis: probation re-entry score
    probation_s: float = 3600.0   # quarantine duration before release
    blame_cooldown_s: float = 600.0   # min gap between blames of a node


@dataclass
class _Obs:
    t: float
    job: str
    key: str                      # model key (profile name)
    nodes: frozenset[int]
    ratio: float                  # measured / predicted


@dataclass
class HealthLedgerEntry:
    t: float
    node: int
    delta: float
    reason: str                   # blame | heal | op-fail | probation


@dataclass
class HealthReport:
    """What one poll decided: nodes to quarantine / release now."""
    quarantine: list[int] = field(default_factory=list)
    release: list[int] = field(default_factory=list)


class HealthMonitor:
    def __init__(self, cfg: HealthConfig | None = None):
        self.cfg = cfg or HealthConfig()
        self.ledger: list[HealthLedgerEntry] = []
        self.scores: dict[int, float] = {}       # default 1.0
        self.quarantined: set[int] = set()
        self._release_at: dict[int, float] = {}
        self._last_blame: dict[int, float] = {}
        self._window: list[tuple[_Obs, bool]] = []   # (obs, suspect)
        # counters surfaced in SimResult / bench rows
        self.n_suspect_obs = 0
        self.n_blames = 0
        self.n_quarantines = 0
        self.n_releases = 0

    # ------------------------------------------------------------------
    @property
    def excluded_nodes(self) -> set[int]:
        """Nodes whose observations calibration must ignore: anything
        currently blamed below full health or quarantined."""
        return self.quarantined | {n for n, s in self.scores.items()
                                   if s < 1.0}

    def score(self, node: int) -> float:
        return self.scores.get(node, 1.0)

    # ------------------------------------------------------------------
    def _append(self, t: float, node: int, delta: float,
                reason: str) -> None:
        self.ledger.append(HealthLedgerEntry(t, node, delta, reason))
        s = self.scores.get(node, 1.0) + delta
        self.scores[node] = min(1.0, max(0.0, s))

    def debit(self, t: float, node: int, reason: str = "op-fail",
              amount: float | None = None) -> None:
        """External debit — flaky-operation exhaustion lands here."""
        self._append(t, node, -(amount if amount is not None
                                else self.cfg.op_debit), reason)

    # ------------------------------------------------------------------
    def observe(self, t: float, job: str, key: str,
                nodes: frozenset[int], measured: float,
                predicted: float) -> None:
        """One telemetry observation (same stream calibration sees)."""
        if predicted <= 0.0 or not nodes:
            return
        ratio = measured / predicted
        suspect = ratio >= self.cfg.suspect_ratio
        if suspect:
            self.n_suspect_obs += 1
        self._window.append(
            (_Obs(t, job, key, frozenset(nodes), ratio), suspect))
        if not suspect:
            # healthy evidence heals every involved node that is below
            # full score (ledger stays bounded: no entry at score 1.0)
            for n in nodes:
                if n not in self.quarantined \
                        and self.scores.get(n, 1.0) < 1.0:
                    self._append(t, n, self.cfg.heal_credit, "heal")

    # ------------------------------------------------------------------
    def _blame_nodes(self, t: float) -> list[int]:
        """Apply the attribution rules over the current window."""
        cfg = self.cfg
        win = [(o, s) for o, s in self._window
               if t - o.t <= cfg.window_s]
        self._window = win
        per_node: dict[int, list[tuple[_Obs, bool]]] = {}
        for o, s in win:
            for n in o.nodes:
                per_node.setdefault(n, []).append((o, s))
        blamed = []
        for n, obs in sorted(per_node.items()):
            if n in self.quarantined:
                continue
            if t - self._last_blame.get(n, -1e18) < cfg.blame_cooldown_s:
                continue
            sus = [o for o, s in obs if s]
            if len(sus) < cfg.min_suspect:
                continue
            if len(sus) / len(obs) < cfg.suspect_frac:
                continue
            # cross-job (or self-attributing single-node) evidence
            jobs = {o.job for o in sus}
            if len(jobs) < 2 and not any(len(o.nodes) == 1 for o in sus):
                continue
            # not-drift: several model keys degraded at once, or the
            # same key runs healthy on a disjoint placement
            keys = {o.key for o in sus}
            if len(keys) < 2:
                key = next(iter(keys))
                healthy_elsewhere = any(
                    (not s) and o.key == key and n not in o.nodes
                    for o, s in win)
                if not healthy_elsewhere:
                    continue
            blamed.append(n)
        return blamed

    def poll(self, t: float) -> HealthReport:
        """Evaluate evidence; returns quarantine/release decisions the
        simulator forwards to the scheduler."""
        cfg = self.cfg
        rep = HealthReport()
        for n in self._blame_nodes(t):
            self._append(t, n, -cfg.blame_debit, "blame")
            self._last_blame[n] = t
            self.n_blames += 1
        for n in sorted(self.scores):
            if n not in self.quarantined \
                    and self.scores[n] < cfg.quarantine_below:
                self.quarantined.add(n)
                self._release_at[n] = t + cfg.probation_s
                self.n_quarantines += 1
                rep.quarantine.append(n)
        for n in sorted(self._release_at):
            if t >= self._release_at[n]:
                del self._release_at[n]
                self.quarantined.discard(n)
                self.n_releases += 1
                # probation re-entry: ledger credit back up to the
                # hysteresis score, so the recompute invariant holds
                delta = cfg.recover_above - self.scores.get(n, 1.0)
                if delta > 0.0:
                    self._append(t, n, delta, "probation")
                rep.release.append(n)
        return rep

    # ------------------------------------------------------------------
    def recompute_scores(self) -> dict[int, float]:
        """Replay the ledger from scratch (sanitizer ground truth)."""
        scores: dict[int, float] = {}
        for e in self.ledger:
            s = scores.get(e.node, 1.0) + e.delta
            scores[e.node] = min(1.0, max(0.0, s))
        return scores
