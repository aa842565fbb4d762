"""Subject-level train/val/test splitting.

``metadata.txt`` lines are ``relpath|subject``; subjects are sorted and
de-duplicated; the last ``num_test_subject`` subjects form the held-out
test set; the remainder is chunked into k contiguous eval folds
(cross_validation=1 means a single 80/20 split).
"""

from __future__ import annotations

import os
from typing import List, Tuple


class DataSplitter:
    def __init__(
        self,
        data_path: str,
        cross_validation: int = 5,
        num_test_subject: int = 10,
    ):
        self.data_path = data_path
        self.cross_validation = cross_validation

        entries: List[Tuple[str, str]] = []
        with open(os.path.join(data_path, "metadata.txt")) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                relpath, subject = line.split("|")[:2]
                entries.append((relpath, subject))
        self.entries = entries

        subjects = sorted({s for _, s in entries})
        if num_test_subject >= len(subjects):
            raise ValueError(
                f"num_test_subject={num_test_subject} leaves no training "
                f"subjects (dataset has {len(subjects)})"
            )
        self.subjects_train = subjects[:-num_test_subject]
        self.subjects_test = subjects[-num_test_subject:]

        n = len(self.subjects_train)
        if cross_validation != 1:
            divider = n // cross_validation
        else:
            divider = int(n * 0.2)
        if divider < 1:
            raise ValueError(
                f"{n} training subjects cannot form {cross_validation} "
                "cross-validation fold(s) with a non-empty eval split; "
                "lower num_test_subject or cross_validation"
            )

        self.subjects_cv_eval: List[List[str]] = []
        self.subjects_cv_train: List[List[str]] = []
        for i in range(cross_validation):
            ev = self.subjects_train[divider * i: min(divider * (i + 1), n)]
            self.subjects_cv_eval.append(ev)
            self.subjects_cv_train.append(
                [s for s in self.subjects_train if s not in ev]
            )

        def select(subject_list):
            ss = set(subject_list)
            return [r for r, s in entries if s in ss]

        self.data_train = select(self.subjects_train)
        self.data_test = select(self.subjects_test)
        self.data_cv_eval = [select(s) for s in self.subjects_cv_eval]
        self.data_cv_train = [select(s) for s in self.subjects_cv_train]
