"""Exponentially weighted decaying mean with bias correction
(style_transfer2_tpu/utils/meanvar.py; reference utils.py:49-69): the
serving tier's iterations-per-second estimate."""


class DecayingMean:
    """An exponentially weighted decaying mean with initialization bias
    correction. Calling it with a value decays the mean toward that value;
    calling it with no value returns the bias-corrected mean (0 while
    empty)."""

    def __init__(self, decay=0.9):
        self.mean = 0
        self.decay = decay
        self.items = 0

    def __call__(self, item=None):
        if item is not None:
            self.mean = self.decay * self.mean + (1 - self.decay) * item
            self.items += 1
        if self.items == 0:
            return self.mean
        return self.mean / (1 - self.decay ** self.items)

    def clear(self):
        """Resets the decaying mean to empty."""
        self.mean = 0
        self.items = 0
