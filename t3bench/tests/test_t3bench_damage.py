"""The frozen damage model draws what the program's ``bench/damage.py``
draws, and applies it the same way."""
import numpy as np
import torch

from t3bench.lib import damage as frozen


def test_frozen_copy_draws_the_same():
    from ternary_image_codec_tpu_torch.bench import damage as program
    for kw in ({"D": 101, "E": 8, "overcap": 0.0, "hdr": 0.25},
               {"D": 20, "E": 8, "overcap": 0.25, "hdr": 0.25}):
        a = frozen.damage(2025, 10276, 3, seed=20261017, **kw)
        b = program.damage(2025, 10276, 3, seed=20261017, **kw)
        for x, y in zip(a[0] + a[1], b[0] + b[1]):
            assert np.array_equal(x, y)
        w = torch.randint(0, 27, (3, 2025, 9, 16), dtype=torch.int8,
                          generator=torch.Generator().manual_seed(1))
        ev = tuple(np.minimum(x, 15) if i == 3 else x
                   for i, x in enumerate(a[0]))
        assert torch.equal(frozen.apply(w, ev), program.apply(w, ev))
