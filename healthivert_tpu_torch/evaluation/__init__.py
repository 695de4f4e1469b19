"""The offline evaluation: generation quality, RHLV and the SVM Genant grading."""
