"""Training interactions consumed per second: the split's train pairs
times the epochs completed, over the window's start to the synchronised
end of the last epoch."""


def read(run):
    if run.kind != "train":
        return None
    return run.shape["train_pairs"] * len(run.units) / run.window_s
