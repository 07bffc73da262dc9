"""The share of the arcs the push-relabel kernel's walks read that its CTA
walks of long segments read: ``arcs_cta_walked`` over ``arcs_discharged +
arcs_relabelled`` (``last_stats``), summed over the window, in percent.
Nothing where no solve carries the counter."""


def read(run):
    stats = [s for s in run.stats if s and "arcs_cta_walked" in s]
    total = sum(s["arcs_discharged"] + s["arcs_relabelled"] for s in stats)
    if not total:
        return None
    return 100.0 * sum(s["arcs_cta_walked"] for s in stats) / total
