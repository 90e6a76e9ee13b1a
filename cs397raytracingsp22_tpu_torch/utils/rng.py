"""Draw-site addressing for the render path's counter-based RNG.

Every draw is addressed by (seed, ray_uid, site, lane): `ray_uid =
pixel_id * spp + sample_id`, and `site` names the draw site (camera
jitter, bounce 0, bounce 1, ...). Draws follow content, not buffer
position, so an image does not depend on how rays are chunked. The
generator is utils/threefry.py.
"""

# Draw-site tags. Bounces use SITE_BOUNCE0 + bounce index.
SITE_CAMERA = 0
SITE_BOUNCE0 = 1
# Next-event estimation draws (render/nee.py): SITE_NEE0 + bounce index, a
# range apart from the bounce sites, so turning NEE on leaves the path's
# own draws as they were. A site lives in the counter's upper 16 bits
# (threefry._site_base: site << 16), so the base stays below 2^16: a
# larger one would wrap onto the camera site and share its draws.
SITE_NEE0 = 1 << 12
