"""E-cash scenario: issue, then ATOMIC spend (the port's copy of
`coconut_tpu/scenarios/ecash.py`).

A coin is a credential; THE SPEND IS the show-verify — the engine
WAL-commits the coin's nullifier under the store lock BEFORE the
client's future resolves (engine/phases.py demux), so "verified" and
"spent" are one atomic fact. The nullifier domain is "ecash" with a
spend tag derived from the coin's minted bytes, so ANY second spend
of the same coin — an exact transcript replay OR a fresh
re-randomized show — derives the same nullifier and surfaces as a
typed DoubleSpendError end-to-end (engine, wire envelope, client).

Each workflow: mint a coin if the wallet is empty, spend it, and with
probability `double_spend_p` ALSO attempt to re-spend the coin that
was just consumed (alternating between exact replay of the recorded
spend transcript and a fresh show of the spent coin — both must be
caught). Honest spends that draw a DoubleSpendError finish `failed`:
that would be the detector misfiring, and the drills assert zero."""

from ..errors import DoubleSpendError
from .base import ScenarioBase, ScenarioWorkflow, issue_credential, \
    show_credential
from .workflow import Step

DOMAIN = "ecash"


class EcashScenario(ScenarioBase):
    name = "ecash"

    def __init__(self, client, params, double_spend_p=0.1,
                 deadline_s=30.0):
        super().__init__(client, params, deadline_s=deadline_s)
        self.double_spend_p = float(double_spend_p)

    def workflow(self, user, rng):
        return EcashWorkflow(self, user, rng)


class EcashWorkflow(ScenarioWorkflow):
    name = "ecash"

    def script(self):
        sc, user, rng = self.scenario, self.user, self.rng
        if user.coin is None:
            user.coin = yield from issue_credential(sc, user)
        coin = user.coin
        tag = sc.tag_for(coin, DOMAIN)
        verdict, show = yield from show_credential(
            sc, user, coin, domain=DOMAIN, tag=tag, step_name="spend"
        )
        self.check(verdict, "honest spend rejected as invalid")
        # the spend is durable the moment the future resolved: consume
        # the coin and keep the transcript as replay bait
        user.coin = None
        user.spent_show = (show, tag)
        user.shows_done += 1
        if rng.random() < sc.double_spend_p:
            # attacker move: re-spend the consumed coin. Even rounds
            # replay the exact recorded transcript; odd rounds run a
            # FRESH re-randomized show of the spent coin — the spend
            # tag catches both.
            self.expect_rejection = True
            if user.shows_done % 2 == 0:
                (proof, challenge, revealed, epoch), tag = user.spent_show
                client = sc.client
                yield Step(
                    "respend_replay",
                    lambda: client.submit_show_verify(
                        proof, revealed, challenge, epoch=epoch,
                        domain=DOMAIN, tag=tag,
                    ),
                )
            else:
                yield from show_credential(
                    sc, user, coin, domain=DOMAIN, tag=tag,
                    step_name="respend",
                )
            self.check(False, "double spend of %s was ACCEPTED" % DOMAIN)

    def classify(self, step, exc):
        if self.expect_rejection and isinstance(exc, DoubleSpendError):
            return "double_spend"
        return None
