"""Scan-comparison metrics: confusion matrix, IoU/accuracy, compare."""
