"""Host-side metric accumulators.

Counterpart of paddle_tpu/fluid/metrics.py, a copy (reference
python/paddle/fluid/metrics.py: MetricBase, CompositeMetric, Precision,
Recall, Accuracy, ChunkEvaluator, EditDistance, Auc): numpy over
fetched values, no op and no device.
"""
from __future__ import annotations

import numpy as np

__all__ = ["MetricBase", "CompositeMetric", "Precision", "Recall",
           "Accuracy", "ChunkEvaluator", "EditDistance", "Auc"]


class MetricBase:
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__

    def reset(self):
        for attr, value in self.__dict__.items():
            if attr.startswith("_"):
                continue
            if isinstance(value, int):
                setattr(self, attr, 0)
            elif isinstance(value, float):
                setattr(self, attr, 0.0)
            elif isinstance(value, (np.ndarray,)):
                setattr(self, attr, np.zeros_like(value))

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        self._metrics.append(metric)

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class Precision(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(np.int64).reshape(-1)
        labels = np.asarray(labels).astype(np.int64).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fp += int(np.sum((preds == 1) & (labels == 0)))

    def eval(self):
        return self.tp / max(self.tp + self.fp, 1)


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(np.int64).reshape(-1)
        labels = np.asarray(labels).astype(np.int64).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fn += int(np.sum((preds == 0) & (labels == 1)))

    def eval(self):
        return self.tp / max(self.tp + self.fn, 1)


class Accuracy(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        self.value += float(np.asarray(value).reshape(-1)[0]) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("no batches accumulated")
        return self.value / self.weight


class ChunkEvaluator(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks,
               num_correct_chunks):
        self.num_infer_chunks += int(np.asarray(num_infer_chunks).sum())
        self.num_label_chunks += int(np.asarray(num_label_chunks).sum())
        self.num_correct_chunks += int(np.asarray(num_correct_chunks).sum())

    def eval(self):
        precision = (self.num_correct_chunks /
                     max(self.num_infer_chunks, 1))
        recall = self.num_correct_chunks / max(self.num_label_chunks, 1)
        f1 = (2 * precision * recall / max(precision + recall, 1e-6)
              if self.num_correct_chunks else 0.0)
        return precision, recall, f1


class EditDistance(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        distances = np.asarray(distances).reshape(-1)
        self.total_distance += float(distances.sum())
        self.seq_num += int(seq_num)
        self.instance_error += int(np.sum(distances != 0))

    def eval(self):
        avg = self.total_distance / max(self.seq_num, 1)
        err_rate = self.instance_error / max(self.seq_num, 1)
        return avg, err_rate


class Auc(MetricBase):
    def __init__(self, name=None, curve="ROC", num_thresholds=200):
        super().__init__(name)
        self._curve = curve
        self._num_thresholds = num_thresholds
        self.tp = np.zeros(num_thresholds, dtype=np.int64)
        self.fp = np.zeros(num_thresholds, dtype=np.int64)
        self.tn = np.zeros(num_thresholds, dtype=np.int64)
        self.fn = np.zeros(num_thresholds, dtype=np.int64)

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).reshape(-1)
        pos_prob = preds[:, -1] if preds.ndim > 1 else preds
        t = self._num_thresholds
        thresholds = (np.arange(t) + 1.0) / (t + 1.0)
        for i, thr in enumerate(thresholds):
            pred_pos = pos_prob > thr
            self.tp[i] += int(np.sum(pred_pos & (labels > 0)))
            self.fp[i] += int(np.sum(pred_pos & (labels == 0)))
            self.tn[i] += int(np.sum(~pred_pos & (labels == 0)))
            self.fn[i] += int(np.sum(~pred_pos & (labels > 0)))

    def eval(self):
        tpr = self.tp / np.maximum(self.tp + self.fn, 1e-6)
        fpr = self.fp / np.maximum(self.fp + self.tn, 1e-6)
        return float(np.sum((fpr[:-1] - fpr[1:]) * (tpr[:-1] + tpr[1:]) / 2))
