"""Typed findings and the allowlist of the graph lint — the counterpart of
``paddle_tpu/analysis/findings.py``.

A ``Finding`` is one rule violation on one traced program: rule id,
severity, message, where it comes from (the FX node's user frame, or the
argument path for input-level findings) and a remediation. Severities:

* ``high`` — will burn a run: a doubled buffer (an update that leaves as a
  new buffer instead of being written in place), an f32 matmul in a bf16
  block, a host synchronisation inside a captured step, a capture per
  call. Gated: the CLI ``--self-check`` fails on any high finding that is
  not allowlisted.
* ``warn`` — costs something or is fragile, but does not by itself sink a
  run.
* ``info`` — context; never gated.

An ``Allowlist`` suppresses findings that are INTENTIONAL, each with its
reason: the suppression shows in ``Report.suppressed`` instead of being
dropped, so "clean" means "clean or explained". Entries match on rule id,
a glob over program names, an optional message / provenance substring and
optionally on the torch device types the program's tensors live on
(``"cpu"``, ``"cuda"``). JAX's built-in entry (the CPU backend's missing
buffer donation in ``generate_paged``) has no counterpart: the port writes
its pools in place on every device, so the port's built-in list is empty.
"""
from __future__ import annotations

import fnmatch

__all__ = ["HIGH", "WARN", "INFO", "SEVERITIES", "Finding",
           "AllowlistEntry", "Allowlist", "BUILTIN_ALLOWLIST",
           "stale_allowlist_findings"]

HIGH = "high"
WARN = "warn"
INFO = "info"
SEVERITIES = (HIGH, WARN, INFO)


class Finding:
    """One rule violation on one analyzed program."""

    __slots__ = ("rule", "severity", "message", "where", "subject",
                 "remediation")

    def __init__(self, rule, severity, message, *, where="", subject="",
                 remediation=""):
        if severity not in SEVERITIES:
            raise ValueError(f"severity must be one of {SEVERITIES}, "
                             f"got {severity!r}")
        self.rule = rule
        self.severity = severity
        self.message = message
        self.where = where            # "file:line (fn)" or an argument path
        self.subject = subject        # program name (set by the analyzer)
        self.remediation = remediation

    def to_dict(self) -> dict:
        return {"rule": self.rule, "severity": self.severity,
                "message": self.message, "where": self.where,
                "subject": self.subject, "remediation": self.remediation}

    def __repr__(self):
        return (f"Finding({self.rule}, {self.severity}, {self.subject!r}, "
                f"{self.message!r})")

    def render(self) -> str:
        loc = f" @ {self.where}" if self.where else ""
        fix = f"\n      fix: {self.remediation}" if self.remediation else ""
        return (f"[{self.severity.upper():4s}] {self.rule}: "
                f"{self.message}{loc}{fix}")


class AllowlistEntry:
    """One justified suppression. ``subject`` is a glob over program names;
    ``contains`` (optional) must appear in the finding's message or
    provenance; ``backends`` (optional) restricts the entry to programs whose
    tensors live on those torch device types (``"cpu"``, ``"cuda"``). ``reason`` is mandatory — an allowlist entry without a
    recorded why is just a weakened rule. ``used`` records whether the entry
    suppressed anything since process start (the stale-suppression audit's
    input: a builtin entry that matched nothing across a full self-check has
    outlived its rule, or its subject glob drifted off the program names)."""

    __slots__ = ("rule", "subject", "contains", "reason", "backends", "used")

    def __init__(self, rule, subject="*", contains=None, *, reason,
                 backends=None):
        if not reason:
            raise ValueError("allowlist entries require a justification "
                             "(reason=)")
        self.rule = rule
        self.subject = subject
        self.contains = contains
        self.reason = reason
        self.backends = tuple(backends) if backends else None
        self.used = False

    def matches(self, finding: Finding, backend: str) -> bool:
        if self.rule != finding.rule:
            return False
        if self.backends is not None and backend not in self.backends:
            return False
        if not fnmatch.fnmatch(finding.subject or "", self.subject):
            return False
        if self.contains and (self.contains not in finding.message
                              and self.contains not in finding.where):
            return False
        return True

    def __repr__(self):
        return (f"AllowlistEntry({self.rule}, subject={self.subject!r}, "
                f"reason={self.reason!r})")


class Allowlist:
    def __init__(self, entries=()):
        self.entries = list(entries)

    def __iter__(self):
        return iter(self.entries)

    def extend(self, entries) -> "Allowlist":
        """A new Allowlist with `entries` appended (builtin stays intact)."""
        return Allowlist(self.entries + list(entries))

    def apply(self, findings, backend: str):
        """Split findings into (kept, suppressed) where suppressed is a list
        of (finding, entry) pairs — suppression is recorded, not silent."""
        kept, suppressed = [], []
        for f in findings:
            entry = next((e for e in self.entries if e.matches(f, backend)),
                         None)
            if entry is None:
                kept.append(f)
            else:
                entry.used = True
                suppressed.append((f, entry))
        return kept, suppressed


def stale_allowlist_findings(named_lists) -> list:
    """WARN ``allowlist-stale`` findings for entries that suppressed nothing.

    ``named_lists``: (label, Allowlist) pairs — the builtin graph / thread /
    surface / hbm lists in the self-check. Call AFTER every report has run;
    ``used`` accumulates across Allowlist.apply calls, so an entry counts as
    live if ANY program tripped it. First-match-wins means a shadowed
    duplicate also reads stale — that is a finding too (delete the shadow).
    A dead suppression is a rule silently weakened for nobody's benefit:
    either its hazard was fixed (delete the entry) or the subject glob no
    longer matches the program names (fix the glob before the hazard
    returns unsuppressed)."""
    out = []
    for label, allowlist in named_lists:
        for e in allowlist:
            if e.used:
                continue
            scope = f" [backends={','.join(e.backends)}]" if e.backends else ""
            out.append(Finding(
                "allowlist-stale", WARN,
                f"builtin {label} allowlist entry matched nothing this "
                f"self-check: rule={e.rule} subject={e.subject!r}"
                f"{scope} (reason on file: {e.reason})",
                subject=f"allowlist:{label}",
                remediation="delete the entry if its hazard was fixed, or "
                            "re-aim the subject glob at the current program "
                            "names"))
    return out


# Intentional, justified exceptions shipped with the port. Keep it SHORT:
# every entry is a finding the analyzer is right about but the code is
# right to keep. JAX's one entry (the CPU backend's missing buffer donation
# of the paged pools) has no cause here: the port writes its pools in place
# on every device (inference/kv_cache.py, ops/paged_attention.py
# paged_scatter_), so the paged programs lint clean without it.
BUILTIN_ALLOWLIST = Allowlist([
    # models/generation.py _inverse_cdf: the sampler's cumulative sum runs
    # in f64 so that an index of zero probability (a top-k cut) is never
    # drawn; it is a scan over the vocabulary, not a product
    AllowlistEntry(
        "dtype-upcast", subject="gpt.decode.*",
        contains="aten._to_copy -> aten.cumsum",
        reason="the sampler's inverse CDF sums the probabilities in f64 on "
               "purpose (models/generation.py _inverse_cdf: no zero-"
               "probability index is ever drawn); no product runs in f64"),
    # models/steps.py kernel_serves: at a head dim the kernels do not take
    # (the smoke zoo's 16), the card runs the plain attention, whose scores
    # are f32 by design (ops/decode_attention.py decode_attention_ref, as
    # JAX's decode_attention_xla accumulates in f32)
    AllowlistEntry(
        "dtype-upcast", subject="gpt.decode.*", contains="upcast from",
        backends=("cuda",),
        reason="the smoke zoo's head dim 16 is not one the attention "
               "kernels take, so on the card its decode programs run the "
               "plain attention, whose f32 scores are the reference's by "
               "design; at head dims 64 and 128 the kernel operator runs "
               "and no upcast is traced"),
])
