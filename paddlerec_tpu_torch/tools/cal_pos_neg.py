"""The positive-order ratio (PNR) of a score file, for the match models.

Counterpart of ``paddlerec_tpu/tools/cal_pos_neg.py``: input lines ``query
\\t score \\t label``; within each block of consecutive lines of one query,
every pair of lines with different labels counts as ordered, misordered or
tied by ``(score_i - score_j)·(label_i - label_j)`` (scores rounded to six
decimals first); prints pnr, query_num, pair_num, equal_num and PNR in the
reference's format.  A score file is what ``tools.predict``'s predictions
and the rows' queries and labels make.

Usage: python -m paddlerec_tpu_torch.tools.cal_pos_neg <score_file>
"""

from __future__ import annotations

import sys
from typing import Dict, List


def cal_pos_neg(path: str) -> Dict[str, float]:
    pos_num = neg_num = equal_num = query_num = 0
    scores: List[float] = []
    labels: List[int] = []
    last_query = None

    def flush():
        nonlocal pos_num, neg_num, equal_num
        for i in range(len(scores)):
            for j in range(i + 1, len(scores)):
                if labels[i] == labels[j]:
                    continue
                d = (scores[i] - scores[j]) * (labels[i] - labels[j])
                if d < 0:
                    neg_num += 1
                elif d > 0:
                    pos_num += 1
                else:
                    equal_num += 1

    with open(path) as f:
        for line in f:
            cols = line.strip().split("\t")
            if len(cols) != 3:
                continue
            if cols[0] != last_query:
                if last_query is not None:
                    flush()
                    scores, labels = [], []
                query_num += 1
                last_query = cols[0]
            scores.append(round(float(cols[1]), 6))
            labels.append(int(cols[2]))
    flush()

    out = {
        "pos_num": pos_num,
        "neg_num": neg_num,
        "equal_num": equal_num,
        "pair_num": pos_num + neg_num + equal_num,
        "query_num": query_num,
    }
    if neg_num > 0:
        out["pnr"] = pos_num / neg_num
        out["PNR"] = pos_num / (pos_num + neg_num)
    return out


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 1:
        print("usage: python -m paddlerec_tpu_torch.tools.cal_pos_neg <input>")
        return 2
    res = cal_pos_neg(argv[0])
    if "pnr" in res:
        print("pnr:{}".format(res["pnr"]))
        print("query_num:{}".format(res["query_num"]))
        print("pair_num:{} , {}".format(res["pair_num"], res["pair_num"]))
        print("equal_num:{}".format(res["equal_num"]))
        print("PNR: {}".format(res["PNR"]))
    print("pos_num: {} , neg_num: {}".format(res["pos_num"], res["neg_num"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
