"""Late fusion of per-modality score files — the port's copy of
`dmcnet_tpu/cli/combine.py` (reference code/dmcnet/combine.py).

combined = wi*iframe + wm*mv + wr*residual [+ wf*flow(DMC)], accuracy by
argmax (combine.py:13-57).  Reads the score files of the port's
`cli/test.py` and `cli/serve.py`, the JAX package's and the reference's
(one format by construction).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def load_scores(path):
    with np.load(path, allow_pickle=True) as data:
        scores = np.array([score[0][0] for score in data["scores"]])
        labels = np.array([score[1] for score in data["scores"]])
        n = len(data["names"])
    return scores, labels, n


def combine(iframe, mv, res, flow=None, wi=2.0, wm=1.0, wr=1.0, wf=1.0):
    i_score, i_label, n = load_scores(iframe)
    mv_score, mv_label, _ = load_scores(mv)
    res_score, res_label, _ = load_scores(res)
    assert (i_label == mv_label).all() and (i_label == res_label).all()
    combined = i_score * wi + mv_score * wm + res_score * wr
    if flow is not None:
        flow_score, _, _ = load_scores(flow)
        combined = combined + wf * flow_score
    accuracy = float(np.sum(np.argmax(combined, axis=1) == i_label)) / n
    return accuracy, n


def main(argv=None):
    parser = argparse.ArgumentParser(description="combine predictions")
    parser.add_argument('--iframe', type=str, required=True,
                        help='iframe score file.')
    parser.add_argument('--mv', type=str, required=True,
                        help='motion vector score file.')
    parser.add_argument('--res', type=str, required=True,
                        help='residual score file.')
    parser.add_argument('--flow', type=str, default=None,
                        help='DMC/flow score file.')
    parser.add_argument('--wi', type=float, default=2.0)
    parser.add_argument('--wm', type=float, default=1.0)
    parser.add_argument('--wr', type=float, default=1.0)
    parser.add_argument('--wf', type=float, default=1.0)
    args = parser.parse_args(argv)
    accuracy, n = combine(args.iframe, args.mv, args.res, args.flow,
                          args.wi, args.wm, args.wr, args.wf)
    print('Accuracy: %f (%d).' % (accuracy, n))
    return accuracy


if __name__ == "__main__":
    main(sys.argv[1:])
