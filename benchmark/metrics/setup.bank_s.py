"""setup.bank_s — seconds of set-up spent building the bank (the
42-view SHOT bank on the card)."""


def read(ctx):
    return ctx["setup"]["bank_s"]
