"""A job's model construction, checkpoint load and push to the card, ms
per Mpx of slide: the sum of `WSIInferManager.timings[s]["model_build"]`
(span `hnt.model.build`, on each manager's first slide) over the
window's slides over their area."""

KEY = "model_build"


def read(facts):
    v = [t[KEY] for t in facts["timings"].values() if KEY in t]
    return 1e3 * sum(v) / facts["mpx"] if v and facts["mpx"] else None
