"""Fit the log-loss constants of the HDR losses (the port's own copy of
arnerf_tpu/insert/fit_log_loss.py; the reference ships the numbers
[0.2935, 0.7607], fitted in insert/tt.py and used in losses.py:52 and
insert_models.py:375):

  python -m arnerf_tpu_torch.insert.fit_log_loss

The target: (a, b) such that b * log((a + x) / (a + y)) approximates a
perceptual HDR difference, here by matching b * log(a + x) + c to mu-law
tonemapping log(1 + 5000 x) / log(5001) over x in [0, 1]. scipy is imported
inside fit(), so the package imports without it.
"""

import numpy as np


def mu_law(x, mu=5000.0):
    return np.log(1 + mu * x) / np.log(1 + mu)


def fit(n=2048):
    """(a, b, c) of the least-squares fit on n points of [0, 1]."""
    from scipy.optimize import curve_fit
    x = np.linspace(0, 1, n)

    def model(x, a, b, c):
        return b * np.log(a + x) + c

    popt, _ = curve_fit(model, x, mu_law(x), p0=[0.3, 0.7, 1.0],
                        maxfev=20000)
    return popt


def main():
    a, b, c = fit()
    print(f"log-loss params: a={a:.4f} b={b:.4f} (offset c={c:.4f})")
    print("reference ships a=0.2935 b=0.7607 (losses.py:52)")
    return a, b, c


if __name__ == "__main__":
    main()
