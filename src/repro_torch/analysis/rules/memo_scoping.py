"""Rule ``unscoped-id``: id()-keyed containers must pin or scope referents.

An ``id()`` integer is only meaningful while the object it was taken
from is alive — after collection the address can be recycled onto an
unrelated object, silently aliasing memo entries (the reference's
``history`` bug, and its ``_walk_sig`` pinning bug).  A store of an
id-derived key is accepted when one of the escape hatches documented in
``base.IdKeyAnalysis`` applies:

* direct keys: the stored value pins the argument itself
  (``members[jid] = js``), or the owning class keeps such a sibling pin
  store (``_PassCtx.members`` covers ``sig_cache``/``gate_wake``/...),
  or the attribute is weakref-scoped (``_scope_memos``-style);
* signature keys (tuples embedding ids): the attribute is
  weakref-scoped, or the entry's value is a live object that embeds the
  keyed referents (curve memos), or the owning class keeps a signature
  pin mapping (``parked_pins``/``_gang_pins``);
* comprehension-built containers are point-in-time snapshots, not
  cross-statement memos, and are exempt.

Everything else needs a ``# lint: unscoped-id`` waiver with a written
justification of what keeps the referents alive.
"""

from __future__ import annotations

from repro_torch.analysis.rules.base import LintModule, Rule, Violation


class MemoScopingRule(Rule):
    rule_id = "unscoped-id"
    description = ("id()-keyed containers must pin referents, be "
                   "weakref-scoped, or carry a waiver")

    def check(self, module: LintModule) -> list[Violation]:
        ana = module.id_analysis()
        out: list[Violation] = []
        for st in ana.stores:
            if st.comprehension:
                continue
            if self._acceptable(ana, st):
                continue
            where = st.container.name or "<expression>"
            out.append(Violation(
                module.relpath, st.line, self.rule_id,
                f"{st.key_kind} id() key stored in {st.container.kind} "
                f"'{where}' without pinning its referent(s): keep the "
                f"object(s) alive alongside the key, weakref-scope the "
                f"container, or waive with justification"))
        return out

    def _acceptable(self, ana, st) -> bool:
        cont = st.container
        if st.key_kind == "direct":
            if st.self_pinned:
                return True
            if cont.kind in ("attr", "expr"):
                owner = cont.owner or (
                    ana.attr_owner(cont.name) if cont.name else None)
                if (owner, cont.name) in ana.weakref_scoped:
                    return True
                if owner in ana.class_direct_pins:
                    return True
            return False
        # signature keys
        if cont.kind in ("attr", "expr"):
            owner = cont.owner or (
                ana.attr_owner(cont.name) if cont.name else None)
            if (owner, cont.name) in ana.weakref_scoped:
                return True
            if st.self_pinned and cont.name is not None:
                # mapping entry whose value is a live object: curve/order
                # memos store objects that embed the keyed referents
                return True
            if owner in ana.class_sig_pins:
                return True
            return False
        return st.self_pinned
