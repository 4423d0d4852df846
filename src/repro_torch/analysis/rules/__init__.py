"""House lint rules for the incremental scheduling core, copied from
``repro.analysis.rules``."""

from repro_torch.analysis.rules.base import (LintModule, Rule,  # noqa: F401
                                       Violation)
from repro_torch.analysis.rules.determinism import DeterminismRule
from repro_torch.analysis.rules.dirty_coverage import DirtyCoverageRule
from repro_torch.analysis.rules.memo_scoping import MemoScopingRule
from repro_torch.analysis.rules.rollback import RollbackRule
from repro_torch.analysis.rules.shape_contracts import ShapeContractRule

ALL_RULES = [
    MemoScopingRule,
    RollbackRule,
    DirtyCoverageRule,
    DeterminismRule,
    ShapeContractRule,
]
