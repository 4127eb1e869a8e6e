"""Finding emitters: text (default), JSON (tooling), SARIF 2.1.0 (code
hosts / CI annotation UIs). All three consume the same `LintResult`; the
exit-code decision stays in `__main__` so emitters are pure."""

from __future__ import annotations

import json

from wam_tpu_torch.lint.core import LintResult
from wam_tpu_torch.lint.registry import all_rules

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                "master/Schemata/sarif-schema-2.1.0.json")


def emit_text(result: LintResult) -> str:
    lines = [f.render() for f in result.findings]
    lines.append(
        f"wam_tpu_torch.lint: {len(result.files)} files, {len(result.findings)} "
        f"findings ({result.suppressed} pragma-suppressed, "
        f"{result.baselined} baselined)")
    return "\n".join(lines)


def emit_json(result: LintResult) -> str:
    return json.dumps(
        {
            "version": 1,
            "files": len(result.files),
            "suppressed": result.suppressed,
            "baselined": result.baselined,
            "findings": [
                {
                    "rule": f.rule,
                    "severity": f.severity,
                    "path": f.path,
                    "line": f.line,
                    "message": f.message,
                }
                for f in result.findings
            ],
        },
        indent=2, sort_keys=True) + "\n"


def emit_sarif(result: LintResult) -> str:
    sev_map = {"error": "error", "warning": "warning"}
    rules_meta = [
        {
            "id": cls.id,
            "shortDescription": {"text": cls.description},
            "defaultConfiguration": {
                "level": sev_map.get(cls.severity, "warning")},
        }
        for cls in all_rules()
    ]
    results = [
        {
            "ruleId": f.rule,
            "level": sev_map.get(f.severity, "warning"),
            "message": {"text": f.message},
            "locations": [
                {
                    "physicalLocation": {
                        "artifactLocation": {
                            "uri": f.path.replace("\\", "/"),
                            "uriBaseId": "SRCROOT",
                        },
                        "region": {"startLine": max(1, f.line)},
                    }
                }
            ],
        }
        for f in result.findings
    ]
    doc = {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "wam_tpu_torch.lint",
                        "informationUri":
                            "https://github.com/wam-tpu/wam_tpu",
                        "rules": rules_meta,
                    }
                },
                "results": results,
            }
        ],
    }
    return json.dumps(doc, indent=2, sort_keys=True) + "\n"


EMITTERS = {"text": emit_text, "json": emit_json, "sarif": emit_sarif}
