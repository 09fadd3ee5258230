"""Entry driver ``corpus_soma``: the ``corpus`` driver (:mod:`.corpus`) on
PAULE's somatosensory model set, with ``continue_learning_tube``.

Set-up is the ``corpus`` driver's; the warm-up also trained the two tube
models, whose release weights and a fresh Adam are then put back too, so
that the judged batch plans against the release's tube models.  Before
the window's first batch, the one judged, the tube embedder's generator
is reseeded with a seed drawn from the run's seed, which the judge takes
as ``mask_seed`` to draw the same dropout masks; that batch's first
synthesis also hands over its tubes (``snap_tubes``), and its first
``train_steps`` steps of each tube model are tapped as the corpus driver
taps the predictive model's; :mod:`..tube_judge` compares them.  Each
unit's work is the somatosensory count (:mod:`..yardstick.soma_work`), and
``tube_adam_steps`` counts its tube models' Adam steps; after the window
each unit's phase split goes to standard error.
"""

import numpy as np
import torch

from .. import program, tube_judge
from ..run import log
from ..yardstick import soma_work
from . import corpus

#: the tube models' trainers on ``Paule`` and their release prefixes
TUBE_TRAINERS = (("tube_trainer", "cp_tube"),
                 ("tube_mel_trainer", "tube_mel"))


def setup(cell):
    tube_judge.install()
    corpus.setup(cell)
    for attr, prefix in TUBE_TRAINERS:
        program.restore(getattr(cell.paule, attr), prefix, cell.weights[0])


def window(cell, seconds, tracer):
    """The ``corpus`` driver's window, its first batch reseeded, its
    tubes kept and its tube models' first steps tapped."""
    from paule_tpu_torch.parallel import batched

    w = cell.workload
    b = w["budget"]
    plan_batch = batched.plan_batch_resynth
    cell.mask_seed = int(np.random.default_rng([cell.seed, 4]).integers(
        1, 2 ** 31 - 1))
    cell.snap_tubes = None
    tube = b.get("continue_learning_tube", False)
    cell.tube_taps = {}

    def first_reseeded(paule_obj, *args, **kw):
        if cell.snap_tubes is not None:
            return plan_batch(paule_obj, *args, **kw)
        paule_obj.tube_generator.manual_seed(cell.mask_seed)
        # the corpus driver's tap of this batch's synthesis
        synthesize = paule_obj._synthesize
        kept = []

        def tubes_kept(cps, *a, **k):
            out = synthesize(cps, *a, **k)
            if not kept:
                kept.append(np.array(out[2]))
            return out

        paule_obj._synthesize = tubes_kept
        if tube:
            cell.tube_taps = {
                prefix: program.TrainTap(getattr(paule_obj, attr), prefix, 0,
                                         w["check"]["train_steps"])
                for attr, prefix in TUBE_TRAINERS}
        try:
            out = plan_batch(paule_obj, *args, **kw)
        finally:
            paule_obj._synthesize = synthesize
            for tap in cell.tube_taps.values():
                tap.close()
        cell.snap_tubes = kept[0]
        return out

    batched.plan_batch_resynth = first_reseeded
    try:
        out = corpus.window(cell, seconds, tracer)
    finally:
        batched.plan_batch_resynth = plan_batch
    for u in cell.units:
        u["work"] = soma_work.corpus_batch(
            2 * u["key"], u["utterances"], n_outer=b["n_outer"],
            n_inner=b["n_inner"], n_epochs=b["n_epochs"],
            batch_size=b["batch_size"], continue_learning_tube=tube,
            dp=w["dp"] if u["utterances"] % w["dp"] == 0 else 1)
        u["tube_adam_steps"] = 2 * u["adam_steps"] if tube else 0
        log(f"batch of {u['utterances']} at {2 * u['key']} frames "
            f"{u['wall']:.3f} s" + "".join(
                f" {k} {v:.3f}" for k, v in u["timings"].items()))
    return out


def gather(cell):
    """The ``corpus`` driver's ``outputs`` and ``inputs`` with the judged
    batch's tubes, its tube models' first steps and the seed of its
    dropout masks."""
    outputs, inputs = corpus.gather(cell)
    outputs["snap_tubes"] = cell.snap_tubes
    if cell.tube_taps:
        # the tube->mel model trains on the tubes in the device's dtype
        held = cell.tube_taps["tube_mel"].inputs[0].dtype
        rows_of = {"cp_tube": outputs["snap_cps"],
                   "tube_mel": torch.as_tensor(np.asarray(
                       cell.snap_tubes)).to(held).double().numpy()}
        outputs["tube_train"] = {prefix: tap.gathered(rows_of[prefix])
                                 for prefix, tap in cell.tube_taps.items()}
    inputs["mask_seed"] = cell.mask_seed
    return outputs, inputs


def close(cell):
    corpus.close(cell)
    del cell.tube_taps
