"""The serving loop's host time of one step: ``serve``'s own unsynchronised
``loop_stages["dispatch"]`` (the call that enqueues ``asr_step``; it waits
where the enqueue blocks on the card), ms per step, its slowest call (the
first, as a rule) left out."""


def read(run):
    stage = run.loop_stages.get("dispatch", {})
    return stage.get("steady_ms_per_call")
