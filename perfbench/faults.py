"""Faults planted in the program, for the tests that see ``correct`` come
out false and for the readings that set the upper end of a limit
(``perfbench/probe.py``).  ``plant`` returns the function that takes the
fault out again.

  frozen        a training step that returns its state unchanged (AdamW
                updates nothing)
  half_batch    half of the batch left out, the mean taken over the rest
  altered       an answer altered where it is produced: one bit of
                Algorithm 1's codes, in the buffer the steps read
  codebook_grad one leaf's gradient wrong where it is produced: the
                ``hash_decode`` backward's codebook gradient with its first
                codebook's slice left out

A system lists the faults its cells can have (``System.faults``) and
plants all but ``frozen`` and ``codebook_grad`` itself (``System.plant``).
"""

from __future__ import annotations

from typing import Callable


def plant(system, fault: str) -> Callable[[], None]:
    if fault not in system.faults():
        raise ValueError(f"no fault {fault!r} in a {system.mode} cell")
    if fault not in ("frozen", "codebook_grad"):
        system.after_build.append(lambda s: s.plant(fault))
        return lambda: None
    if fault == "frozen":
        from repro_torch.train import step as module
        name = "adamw_update"
        wrong = lambda params, grads, state, *a, **k: (params, state)   # noqa: E731
    else:
        from repro_torch.kernels.hash_decode import ops as module
        name = "codebook_grad"
        right = module.codebook_grad

        def wrong(*a, **k):
            d_cb = right(*a, **k)
            d_cb[0] = 0
            return d_cb
    original = getattr(module, name)
    setattr(module, name, wrong)

    def undo():
        setattr(module, name, original)
    return undo
