"""The port's hand-written CUDA kernels and their wrappers.

``COUNT_LOCK`` guards the wrappers' launch counts: the refit loop's
publisher thread and its main thread launch kernels on one card at once,
and an unguarded ``+=`` from two threads could lose a count.
"""

import threading

COUNT_LOCK = threading.Lock()
