"""The card's idle share over one profiled job: 100 x (1 - busy / window),
busy being the union of kernels, copies and fills on the card."""


def read(ctx):
    prof = ctx.get("profile")
    if not prof or prof["window_s"] <= 0 or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
