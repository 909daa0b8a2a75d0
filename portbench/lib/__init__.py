"""The general parts of the harness: the cell's files, the inputs made from the seed, the
work counts and peaks, the window and its trace, the comparisons and the result line."""
