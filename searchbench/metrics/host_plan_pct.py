"""Host engine: the (query, segment) plans that the executor answered on
the host engine (`fallbacks`, and each of `host_routed`'s queries on every
segment) over all plans of the traced window, in percent."""


def read(trace):
    if not trace["plans"]:
        return None
    return 100.0 * trace["host_plans"] / trace["plans"]
