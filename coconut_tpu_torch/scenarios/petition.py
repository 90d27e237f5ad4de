"""Anonymous petition scenario — the Coconut paper's flagship
application (the port's copy of `coconut_tpu/scenarios/petition.py`).

One credential per user; one ANONYMOUS signature per campaign. Each
campaign is a nullifier DOMAIN ("petition/c<k>"), and the signature's
spend tag is derived from (credential, domain) — so:

  - signing campaign A then campaign B with the same credential is
    ALLOWED (different domains -> different keyspaces, different tags);
  - signing campaign A twice is CAUGHT, even though the second show is
    freshly re-randomized (same credential + same domain -> same tag
    -> same nullifier -> typed DoubleSpendError);
  - two signatures on the same campaign from DIFFERENT users never
    collide (different credentials -> different tags).

A configurable fraction of workflows DELIBERATELY re-sign a campaign
the user already signed (`resign_p`) — those must finish `rejected`
with the double_spend label; an HONEST sign that draws a
DoubleSpendError finishes `failed`, which the drills assert never
happens."""

from ..errors import DoubleSpendError
from .base import ScenarioBase, ScenarioWorkflow, issue_credential, \
    show_credential
from .workflow import REJECTED


def campaign_domain(campaign):
    return "petition/c%03d" % campaign


class PetitionScenario(ScenarioBase):
    name = "petition"

    def __init__(self, client, params, campaigns=4, resign_p=0.1,
                 deadline_s=30.0):
        super().__init__(client, params, deadline_s=deadline_s)
        self.campaigns = int(campaigns)
        self.resign_p = float(resign_p)

    def workflow(self, user, rng):
        return PetitionWorkflow(self, user, rng)


class PetitionWorkflow(ScenarioWorkflow):
    name = "petition"

    def script(self):
        sc, user, rng = self.scenario, self.user, self.rng
        if user.credential is None:
            user.credential = yield from issue_credential(sc, user)
        cred = user.credential
        unsigned = [
            c for c in range(sc.campaigns) if c not in user.signed
        ]
        resign = bool(user.signed) and (
            not unsigned or rng.random() < sc.resign_p
        )
        if resign:
            # deliberately double-sign a campaign this user already
            # signed: the fresh re-randomized show MUST be rejected by
            # the campaign-scoped spend tag, not by transcript replay
            campaign = sorted(user.signed)[
                rng.randrange(len(user.signed))
            ]
            self.expect_rejection = True
        else:
            campaign = unsigned[rng.randrange(len(unsigned))]
        domain = campaign_domain(campaign)
        verdict, _show = yield from show_credential(
            sc, user, cred,
            domain=domain, tag=sc.tag_for(cred, domain),
            step_name="sign",
        )
        self.check(verdict, "petition signature rejected as invalid")
        self.check(
            not self.expect_rejection,
            "deliberate re-sign of %s was ACCEPTED" % domain,
        )
        user.signed.add(campaign)
        user.shows_done += 1

    def classify(self, step, exc):
        if self.expect_rejection and isinstance(exc, DoubleSpendError):
            return "double_spend"
        return None

    def on_terminal(self, run):
        if run.outcome == REJECTED:
            self.user.shows_done += 1
