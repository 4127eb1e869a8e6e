"""Rule registry: rules self-register at import time; the CLI and tests
resolve them by id. Keeping registration declarative (a decorator on the
class) means adding a rule is: write the class, import its module from
`wam_tpu_torch.lint.rules`, done — the CLI, `--list-rules`, scope union, and
the SARIF rule catalog all pick it up from here."""

from __future__ import annotations

from wam_tpu_torch.lint.core import Finding, LintContext, SourceFile  # noqa: F401

__all__ = ["Rule", "register", "all_rules", "get_rule", "rule_ids"]

_REGISTRY: dict[str, type] = {}


class Rule:
    """Base class for one static-analysis rule.

    Class attributes:
      id          stable kebab-case identifier (pragmas/baseline key on it)
      severity    "error" | "warning"
      scope       repo-relative path prefixes this rule runs on by default
                  (None = every file the run was pointed at)
      description one-liner for --list-rules and the SARIF rule catalog
    """

    id: str = ""
    severity: str = "error"
    scope: tuple[str, ...] | None = None
    description: str = ""

    def __init__(self, config: dict | None = None):
        self.config = dict(config or {})

    def check_file(self, src: SourceFile, ctx: LintContext) -> list[Finding]:
        raise NotImplementedError

    def finding(self, line: int, message: str) -> Finding:
        # path/abspath are filled in by core.run_rules
        return Finding(rule=self.id, severity=self.severity, path="",
                       line=line, message=message)


def register(cls: type) -> type:
    if not cls.id:
        raise ValueError(f"rule {cls.__name__} has no id")
    if cls.id in _REGISTRY:
        raise ValueError(f"duplicate rule id {cls.id!r}")
    _REGISTRY[cls.id] = cls
    return cls


def all_rules() -> list[type]:
    import wam_tpu_torch.lint.rules  # noqa: F401 - triggers registration

    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


def rule_ids() -> list[str]:
    return [c.id for c in all_rules()]


def get_rule(rule_id: str) -> type:
    import wam_tpu_torch.lint.rules  # noqa: F401 - triggers registration

    try:
        return _REGISTRY[rule_id]
    except KeyError:
        raise KeyError(
            f"unknown rule {rule_id!r}; known: {', '.join(sorted(_REGISTRY))}"
        ) from None
