"""Faults planted in the program under test, to show that the comparison
catches them (benchmark/calibrate.py --fault, and the CPU tests):

  answer   the final image given back without the mean added: the answer
           altered where it is produced (the deprocess kernel's wrapper);
  nan      the images of every second job (counted by the engine's
           resets) given back non-finite: a job that went wrong where its
           answer is produced (the same wrapper);
  frozen   an L-BFGS step that evaluates and returns its state unchanged;
  stale    an L-BFGS step whose gradient has the previous step's added to
           it: a wrong backward in the step's graph, which leaves the loss
           it reports right;
  runaway  an L-BFGS step taken at 1000 times the step size it was given
           (multiplied as the step receives it, so a captured step graph
           keeps it): a job that overflows where the reference, stepping
           from the same state, does not;
  half     the batched engine's step applied to the first half of its
           lanes only (the rest keep their state).
"""

FAULTS = ('answer', 'nan', 'frozen', 'stale', 'runaway', 'half')


def plant(fault, setattr=setattr):
    """Plants `fault` in the program's modules (pass pytest's
    monkeypatch.setattr to have it undone)."""
    import style_transfer2_tpu_torch.engine.transfer as transfer
    import style_transfer2_tpu_torch.optim.lbfgs as lbfgs
    if fault == 'answer':
        def deprocess_without_mean(x):
            return x.detach().float().reshape(x.shape[-3:]).clone()
        setattr(transfer, 'deprocess_on_device', deprocess_without_mean)
    elif fault == 'nan':
        engine = transfer.StyleTransfer
        reset, deprocess = engine.reset, transfer.deprocess_on_device
        jobs = [0]

        def counting_reset(self):
            jobs[0] += 1
            return reset(self)

        def nan_every_second_job(x):
            image = deprocess(x)
            return image * float('nan') if jobs[0] % 2 == 0 else image
        setattr(engine, 'reset', counting_reset)
        setattr(transfer, 'deprocess_on_device', nan_every_second_job)
    elif fault == 'frozen':
        def frozen(state, opfunc, step_size):
            loss, grad, aux = opfunc(state['x'])
            return dict(state), loss, aux
        setattr(lbfgs, 'step', frozen)
    elif fault == 'stale':
        step = lbfgs.step

        def stale(state, opfunc, step_size):
            def with_stale_grad(x):
                loss, grad, aux = opfunc(x)
                return loss, grad + state['grad'], aux
            return step(state, with_stale_grad, step_size)
        setattr(lbfgs, 'step', stale)
    elif fault == 'runaway':
        step = lbfgs.step

        def runaway(state, opfunc, step_size):
            return step(state, opfunc, step_size * 1000.0)
        setattr(lbfgs, 'step', runaway)
    elif fault == 'half':
        step_lanes = lbfgs.step_lanes

        def half(state, opfunc, step_sizes, run=None):
            new, loss, aux = step_lanes(state, opfunc, step_sizes, run)
            keep = state['x'].shape[0] // 2
            new = dict(new)
            for k in ('x', 'loss', 'grad'):
                new[k] = new[k].clone()
                new[k][keep:] = state[k][keep:]
            return new, loss, aux
        setattr(lbfgs, 'step_lanes', half)
    else:
        raise ValueError('unknown fault %r' % (fault,))
