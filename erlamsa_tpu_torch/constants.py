"""Engine constants the batch mutation path and the host oracle read
(values mirror the reference's tunables, src/erlamsa.hrl:44-66)."""

# Basic patterns trigger a mutation on a block with probability
# 1/rand(INITIAL_IP) (src/erlamsa.hrl:44, src/erlamsa_patterns.erl:271).
INITIAL_IP = 24

# Probability that a "many" pattern keeps mutating (src/erlamsa.hrl:45).
REMUTATE_PROBABILITY = (4, 5)

# Upper bound on burst/many rounds on the device path; the geometric chain
# is truncated here (src/erlamsa.hrl:46).
MAX_BURST_MUTATIONS = 16

# Generator block envelope (src/erlamsa.hrl:47-50).
MIN_BLOCK_SIZE = 256
AVG_BLOCK_SIZE = 2048
MAX_BLOCK_SIZE = 2 * AVG_BLOCK_SIZE

# Hard cap on a single mutable block (src/erlamsa.hrl:51-52).
ABSMAXHALF_BINARY_BLOCK = 500_000
ABSMAX_BINARY_BLOCK = 2 * ABSMAXHALF_BINARY_BLOCK

# Mutator self-adjusting score range (src/erlamsa_mutations.erl:42-43).
MIN_SCORE = 2.0
MAX_SCORE = 10.0

# Sizer / checksum field search limits (src/erlamsa.hrl:57-58).
SIZER_MAX_FIRST_BYTES = 512
PREAMBLE_MAX_BYTES = 32

# Per-case wall-clock budget of host-routed work, seconds
# (src/erlamsa_cmdparse.erl:109-111).
DEFAULT_MAX_RUNNING_TIME = 30.0

# Output failure tolerance (src/erlamsa.hrl:55, src/erlamsa_main.erl:170-175).
TOO_MANY_FAILED_ATTEMPTS = 10

# Logging payload cap (src/erlamsa.hrl:56).
MAX_LOG_DATA = 10_000_000

# Batch capacity classes: sample buffers are padded to the smallest class
# >= seed length * growth slack.
CAPACITY_CLASSES = (256, 1024, 2048, 4096, 8192, 16384, 65536, 262144,
                    ABSMAX_BINARY_BLOCK)

# Distributed nodes keepalive/eviction, seconds (src/erlamsa.hrl:64-66);
# services/cmanager.py re-exports it for the cluster modules.
NODE_ALIVE_DELTA = 17.0

# Connect-monitor default port, advertised to the SSRF/shell-inject
# payloads (src/erlamsa_mon_connect.erl:27-29, src/erlamsa_mutations.erl:703).
DEFAULT_CM_PORT = 51234

# Edge-coverage bitmap width in bytes (8 edges a byte): 8192 edges. It
# lives here, not in ops/coverage.py, so that the monitor plane shares it
# without importing torch code; the hub and checkpoints still carry the
# actual width explicitly.
COVERAGE_MAP_BYTES = 1024
