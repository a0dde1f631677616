"""The zero-findings lint gate over the port: graftlint, the repo's own
static analysis (``tools/graftlint``), run over ``ray_tpu_torch/`` with
every rule, as ``tests/test_graftlint.py`` runs it over ``ray_tpu/``.

No rule is skipped. The rules that pin files of the JAX package (GL006's
frame roster, GL015's ``core/config.py`` flags) read the port's own
modules here and find nothing to flag, so the gate needs no exception
and no baseline. The cache is off: the gate over ``ray_tpu/`` may run
in another worker at the same time and owns it."""
from tools.graftlint import run_lint


def test_port_has_zero_lint_findings():
    findings = run_lint(["ray_tpu_torch"], use_cache=False)
    assert findings == [], "graftlint findings in ray_tpu_torch:\n" + \
        "\n".join(f.render() for f in findings)
