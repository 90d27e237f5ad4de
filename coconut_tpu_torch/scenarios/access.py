"""Attribute-based service access scenario (the port's copy of
`coconut_tpu/scenarios/access.py`).

The paper's third application: a user mints ONE credential over their
attributes, then presents it again and again across a long session —
each presentation a FRESH re-randomized show, so the service verifies
the attributes every time but can link none of the visits to each
other (or to the mint). No nullifier domain and no spend tag: each
honest show derives a fresh transcript nullifier, so repeated access
is never mistaken for a double spend — the unlinkability/double-spend
split the nullifier design exists to preserve.

Workflow: ensure credential, then `session_len` (rng-drawn in
`session_range`) sequential show_prove -> show_verify round trips.
Every verdict must be True; any DoubleSpendError here is a detector
false positive and finishes the run `failed`."""

from .base import ScenarioBase, ScenarioWorkflow, issue_credential, \
    show_credential


class AccessScenario(ScenarioBase):
    name = "access"

    def __init__(self, client, params, session_range=(3, 8),
                 deadline_s=60.0):
        super().__init__(client, params, deadline_s=deadline_s)
        self.session_range = session_range

    def workflow(self, user, rng):
        return AccessWorkflow(self, user, rng)


class AccessWorkflow(ScenarioWorkflow):
    name = "access"

    def script(self):
        sc, user, rng = self.scenario, self.user, self.rng
        if user.credential is None:
            user.credential = yield from issue_credential(sc, user)
        cred = user.credential
        lo, hi = sc.session_range
        session_len = rng.randrange(lo, hi + 1)
        for i in range(session_len):
            verdict, _show = yield from show_credential(
                sc, user, cred, step_name="access%d" % i
            )
            self.check(
                verdict, "re-randomized show %d rejected" % i
            )
            user.shows_done += 1
