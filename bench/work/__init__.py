"""The benchmark's own operation and byte counts, and the chip's peaks.

Every count prices the least work the inputs need, whatever implements
it: attention over the positions each query really attends (no padding,
no masked positions), each operand read once and each result written
once, the top-k routed experts and not the capacity a dispatch pads to.
"""
