"""The benchmark's plain inputs as the measured program's objects. The
program gets these; the reference keeps the plain data they were made
from."""


def params(pool):
    from coconut_tpu_torch.params import GroupContext, Params

    p = pool["params"]
    return Params(p["g"], p["g_tilde"], p["h"], GroupContext("G1"))


def verkey(pool):
    from coconut_tpu_torch.signature import Verkey

    X, Y = pool["vk"]
    return Verkey(X, Y)


def signature(sigma_1, sigma_2):
    from coconut_tpu_torch.signature import Signature

    return Signature(sigma_1, sigma_2)


def show_proof(show, revealed):
    """(PoKOfSignatureProof, revealed messages, challenge) of one show."""
    from coconut_tpu_torch.pok_vc import Proof
    from coconut_tpu_torch.ps import PoKOfSignatureProof

    s1, s2, J, T, responses, revealed_msgs, c = show
    return PoKOfSignatureProof(s1, s2, J, Proof(T, responses), revealed), revealed_msgs, c
