"""The plain reference of a ledger's verdicts: one verdict per record, in
ledger order, each record judged under its own issuer's key.

A record is (issuer, sigma, messages): the issuer's id, the signature (or
its discrete logs) and the messages of that issuer's schema. `verify_exp`
judges it with the issuer's signing key (exact, microseconds a record);
`verify` with the issuer's verkey by the spec's pairing check (~0.2 s a
record). Nothing here imports the measured program.
"""

from . import checks


def verify_exp(record, keys):
    """record (issuer, (log sigma_1, log sigma_2), msgs); keys {issuer:
    signing key (x, [y_j])}."""
    issuer, logs, msgs = record
    return checks.ps_verify_exp(logs, msgs, keys[issuer])


def verify(record, verkeys, params):
    """record (issuer, (sigma_1, sigma_2), msgs); verkeys {issuer:
    (X_tilde, [Y_tilde_j])}; params {"g", "g_tilde"}, shared."""
    issuer, (sigma_1, sigma_2), msgs = record
    return checks.ps_verify(sigma_1, sigma_2, msgs, verkeys[issuer], params)


def verdicts_exp(records, keys):
    """verify_exp of every record, in ledger order."""
    return [verify_exp(r, keys) for r in records]
