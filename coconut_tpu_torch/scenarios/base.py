"""Shared scenario plumbing — the port's copy of
`coconut_tpu/scenarios/base.py`: per-user credential material and the
issue sub-script every scenario opens with.

A scenario object is CONFIG + a workflow factory: it holds the
engine/gateway client (anything with the submit_* surface — a
ProtocolEngine, a GatewayClient, or a router-bound _SessionClient),
the Params, and the scenario knobs; `workflow(user, rng)` stamps out
one Workflow instance per arrival. All user state lives on the User
record (population.py), so a workflow is just a generator frame over
it — millions of users, zero threads.

User crypto material is drawn DETERMINISTICALLY from the user's seed
(attributes and the ElGamal keypair), so a given uid is the same
principal across runs and replicas — which is what makes the petition
re-sign and e-cash double-spend drills reproducible end-to-end."""

import random

from ..ops.fields import R
from ..state.nullifier import spend_tag_of
from .workflow import Step, Workflow, WorkflowCheckError


def ensure_material(user, params):
    """Lazily equip a user with attributes + ElGamal keypair (seeded
    by uid — bit-stable across runs)."""
    if user.msgs is not None:
        return
    rng = random.Random(user.seed ^ 0xC0C0)
    user.msgs = [rng.randrange(1, R) for _ in range(params.msg_count())]
    user.esk = rng.randrange(1, R)
    user.epk = params.ctx.sig.mul(params.g, user.esk)


def cred_bytes(cred, params):
    """Canonical bytes of a minted credential — the spend-tag input.
    Stable across shows: show_prove re-randomizes a COPY, never the
    minted signature itself."""
    return cred.to_bytes(params.ctx)


def issue_credential(scenario, user):
    """Sub-script (use `yield from`): prepare -> mint, returning the
    minted credential. The prepare rides the bulk lane — issuance is
    backfill, shows are interactive; this is exactly the split the
    brownout ladder sheds by."""
    ensure_material(user, scenario.params)
    client = scenario.client
    msgs, epk, esk = user.msgs, user.epk, user.esk
    sig_req, _rand = yield Step(
        "prepare", lambda: client.submit_prepare(msgs, epk, lane="bulk")
    )
    cred = yield Step(
        "mint", lambda: client.submit_mint(sig_req, msgs, esk)
    )
    return cred


def show_credential(scenario, user, cred, domain=None, tag=None,
                    step_name="show"):
    """Sub-script: show_prove -> show_verify (optionally nullifier-
    scoped to `domain`/`tag`); returns the verdict bool. The verify
    epoch is the credential's mint epoch, as stamped by the engine."""
    client = scenario.client
    msgs = user.msgs
    proof, challenge, revealed = yield Step(
        "%s_prove" % step_name,
        lambda: client.submit_show_prove(cred, msgs),
    )
    epoch = getattr(cred, "epoch", None)
    verdict = yield Step(
        "%s_verify" % step_name,
        lambda: client.submit_show_verify(
            proof, revealed, challenge, epoch=epoch,
            domain=domain, tag=tag,
        ),
    )
    return verdict, (proof, challenge, revealed, epoch)


class ScenarioBase:
    """Config + workflow factory. Subclasses set `name` and implement
    `workflow(user, rng)`."""

    name = "scenario"
    #: per-user think-time bounds between workflows (driver reads this)
    think_s = (0.5, 4.0)

    def __init__(self, client, params, deadline_s=30.0):
        self.client = client
        self.params = params
        self.deadline_s = deadline_s

    def workflow(self, user, rng):
        raise NotImplementedError

    def tag_for(self, cred, domain):
        return spend_tag_of(cred_bytes(cred, self.params), domain)


class ScenarioWorkflow(Workflow):
    """A Workflow bound to (scenario, user, rng); the deadline comes
    from the scenario config."""

    def __init__(self, scenario, user, rng):
        self.scenario = scenario
        self.user = user
        self.rng = rng
        self.deadline_s = scenario.deadline_s
        #: scripts set this before a DELIBERATE double-spend/re-sign
        #: attempt; classify() only blesses the typed rejection then
        self.expect_rejection = False

    def check(self, cond, what):
        if not cond:
            raise WorkflowCheckError(what)
