"""The reference's revert-mutation fixtures (its CI script's fedmc and
fedpriv gates) on the port's own files, both ways: each mutation
un-fixes one invariant of the port's control plane, DP leg or secure
aggregation and must fire exactly one finding of its rule (the rule
selected alone), and the unmutated file must lint clean.

FL151's rng half runs twice: with the reference's constant
``np.random.default_rng(0)``, and with its torch meaning, a
``torch.Generator().manual_seed(0)`` drawn from through
``generator=``. FL150 logs the payload as the reference's fixture does,
and through ``.detach().cpu()``."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import os

import pytest

from fedml_tpu_torch.analysis.linter import lint_source

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INTEGRATION = "fedml_tpu_torch/resilience/integration.py"
PRIVACY = "fedml_tpu_torch/program/privacy.py"
MPC = "fedml_tpu_torch/core/mpc.py"

_REPORT = ('            self._controller.report(\n'
           '                msg.get("round"), msg.get("attempt"),'
           ' msg.get_sender_id(),\n'
           '                msg.get("num_samples"),'
           ' self._report_payload(msg))')


def _logged_report(expr):
    return ('            payload = self._report_payload(msg)\n'
            '            logging.info("report from %d: %r",\n'
            f'                         msg.get_sender_id(), {expr})\n'
            '            self._controller.report(\n'
            '                msg.get("round"), msg.get("attempt"),'
            ' msg.get_sender_id(),\n'
            '                msg.get("num_samples"), payload)')


_NOISE_RNG = "        rng = self.noise_rng(rank, round_idx, attempt)\n"
_NOISE_DRAW = ("            out[k] = x + np.float32(self.sigma) * "
               "rng.standard_normal(\n"
               "                x.shape, dtype=np.float32)\n")

#: (id, path, code, [(needle, mutation), ...])
FIXTURES = [
    ("fl141_report_registration_deleted", INTEGRATION, "FL141", [
        ("        self.register_message_receive_handler(MSG_C2S_REPORT,\n"
         "                                              self._on_report)\n",
         "")]),
    ("fl150_payload_logged", INTEGRATION, "FL150", [
        (_REPORT, _logged_report("payload"))]),
    ("fl150_payload_logged_from_the_card", INTEGRATION, "FL150", [
        (_REPORT, _logged_report("payload.detach().cpu()"))]),
    ("fl151_noise_then_clip", PRIVACY, "FL151", [
        ("        clipped = self.clip(delta)\n"
         "        if self.noise_multiplier == 0:\n"
         "            return clipped\n"
         "        return self.noise(clipped, rank, round_idx, attempt)",
         "        noised = self.noise(delta, rank, round_idx, attempt)\n"
         "        return self.clip(noised)")]),
    ("fl151_constant_default_rng", PRIVACY, "FL151", [
        (_NOISE_RNG, "        rng = np.random.default_rng(0)\n")]),
    ("fl151_constant_torch_generator", PRIVACY, "FL151", [
        (_NOISE_RNG, "        import torch\n"
                     "        rng = torch.Generator().manual_seed(0)\n"),
        (_NOISE_DRAW,
         "            out[k] = x + np.float32(self.sigma) * torch.randn(\n"
         "                x.shape, generator=rng).numpy()\n")]),
    ("fl152_dequantize_before_reconstruct", MPC, "FL152", [
        ("    total_q = reconstruct_additive(partials, p)\n"
         "    return dequantize(total_q, scale, p)",
         "    total = reconstruct_additive(\n"
         "        [dequantize(s, scale, p) for s in partials], p)\n"
         "    return total")]),
    ("fl153_privatize_block_deleted", INTEGRATION, "FL153", [
        ('            if self.dp is not None:\n'
         '                # DP before codec, always: the mechanism\'s'
         ' clip->noise\n'
         '                # runs on the raw delta, then the (lossy,'
         ' NON-private)\n'
         '                # uplink encode sees only the privatized'
         ' update --\n'
         '                # fedcheck FL153 pins this order statically\n'
         '                params = self.dp.privatize_params(\n'
         '                    msg.get("params"), params, self.rank,'
         ' rnd, attempt)\n',
         "")]),
]


def _read(rel):
    with open(os.path.join(REPO_ROOT, rel), encoding="utf-8") as fh:
        return fh.read()


@pytest.mark.parametrize("rel,code,edits",
                         [pytest.param(*f[1:], id=f[0]) for f in FIXTURES])
def test_mutation_fires_once_and_the_file_is_clean(rel, code, edits):
    src = _read(rel)
    assert lint_source(src, path=rel, select={code}) == [], \
        (code, "the unmutated file must lint clean")
    mutated = src
    for needle, mutation in edits:
        assert mutated.count(needle) == 1, (code, rel, "needle changed")
        mutated = mutated.replace(needle, mutation)
    found = lint_source(mutated, path=rel, select={code})
    assert [f.code for f in found] == [code], found


def test_fl141_names_the_hung_round():
    needle, mutation = FIXTURES[0][3][0]
    found = lint_source(_read(INTEGRATION).replace(needle, mutation),
                        path=INTEGRATION, select={"FL141"})
    assert "round 0" in found[0].message
    assert "res_report" in found[0].message


def test_the_fixtures_cover_the_reference_gates():
    assert {f[2] for f in FIXTURES} == {"FL141", "FL150", "FL151", "FL152",
                                        "FL153"}
