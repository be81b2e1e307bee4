"""Tennis court geometry constants (copy of ``vid2player3d_tpu/tennis/court.py``).

Singles court, net at y=0; the opponent's bounce target is the far half.
"""

NET_HEIGHT = 1.07      # m at the posts
HALF_WIDTH = 4.11      # singles half width
HALF_LENGTH = 11.89    # baseline distance from net
SERVICE_LINE = 6.4     # service box depth from net

# far-half bounce-in box in this player's frame
COURT_MIN = (-HALF_WIDTH, 0.0)
COURT_MAX = (HALF_WIDTH, HALF_LENGTH)
SERVE_MAX = (HALF_WIDTH, SERVICE_LINE)
